"""Annotation records of Epic-Kitchens trimmed action segments.

Port of the JAX package's ``data/records.py``. Frame-index conventions of
the reference (core/dataset/epic_record.py:25-46):

* RGB / Audio frames are 1-indexed in the CSV -> subtract 1;
* Flow runs at half the visual frame rate -> indices are halved;
* a segment's usable end frame is ``stop_frame - 2`` (RGB / Audio).

Test CSVs (S1/S2) carry no labels -> the label is the -1 sentinel
(reference epic_record.py:49-59).

Tables are read with the standard ``csv`` module into a list of row dicts
(strings; ``record_from_row`` converts). pandas is imported only to read a
``.pkl`` table, and only then is it needed.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Union

MODALITIES = ("RGB", "Flow", "Audio")


@dataclass(frozen=True)
class EpicRecord:
    """One trimmed action segment of an untrimmed Epic-Kitchens video."""

    uid: int
    video_id: str
    start_timestamp: str
    stop_timestamp: str
    csv_start_frame: int
    csv_stop_frame: int
    verb_class: int = -1
    noun_class: int = -1
    action_class: int = -1
    has_labels: bool = False

    @property
    def action_id(self) -> int:
        return self.uid

    @property
    def untrimmed_video_name(self) -> str:
        return self.video_id

    @property
    def start_frame(self) -> Dict[str, int]:
        start = self.csv_start_frame - 1
        return {"RGB": start, "Flow": start // 2, "Audio": start}

    @property
    def end_frame(self) -> Dict[str, int]:
        end = self.csv_stop_frame - 2
        return {"RGB": end, "Flow": end // 2, "Audio": end}

    @property
    def num_frames(self) -> Dict[str, int]:
        start, end = self.start_frame, self.end_frame
        return {m: end[m] - start[m] for m in MODALITIES}

    @property
    def label(self) -> Union[Dict[str, int], int]:
        if not self.has_labels:
            return -1
        label = {"verb": self.verb_class, "noun": self.noun_class}
        if self.action_class >= 0:
            label["action"] = self.action_class
        return label


def read_pickle(path: str):
    """A pandas-pickled object (annotation tables, action names); pandas is
    needed for these files only."""
    try:
        import pandas as pd
    except ImportError as exc:
        raise ImportError(
            f"{path} is a pandas pickle and pandas is not installed; give the "
            "annotations as .csv instead"
        ) from exc
    return pd.read_pickle(path)


def load_annotations(path: str, vid_list: Optional[List[str]] = None,
                     action_id_list: Optional[List[str]] = None) -> List[Dict[str, str]]:
    """The annotation table (csv, or pkl through pandas) as row dicts, kept
    to the videos of ``vid_list`` and the "verb,noun" actions of
    ``action_id_list`` (reference core/dataset/dataset.py:86-112)."""
    if path.endswith(".pkl"):
        table = read_pickle(path)
        rows = [{k: v for k, v in zip(table.columns, values)}
                for values in table.itertuples(index=False, name=None)]
    else:
        with open(path, newline="") as handle:
            rows = list(csv.DictReader(handle))
    if vid_list:
        videos = set(vid_list)
        rows = [r for r in rows if str(r["video_id"]) in videos]
    if action_id_list:
        actions = set(action_id_list)
        rows = [r for r in rows if str(r["action"]) in actions]
    return rows


def record_from_row(row: Mapping, include_action_class: bool = False) -> EpicRecord:
    # all three class columns required, like the reference (epic_record.py:
    # 49-59): the S1/S2 challenge csvs lack them and get -1 labels
    has_labels = {"verb_class", "noun_class", "action_class"} <= set(row.keys())
    return EpicRecord(
        uid=int(row["uid"]),
        video_id=str(row["video_id"]),
        start_timestamp=str(row["start_timestamp"]),
        stop_timestamp=str(row["stop_timestamp"]),
        csv_start_frame=int(row["start_frame"]),
        csv_stop_frame=int(row["stop_frame"]),
        verb_class=int(row["verb_class"]) if has_labels else -1,
        noun_class=int(row["noun_class"]) if has_labels else -1,
        action_class=int(row["action_class"]) if has_labels and include_action_class else -1,
        has_labels=has_labels,
    )


def read_vid_list(path: str) -> List[str]:
    with open(path) as handle:
        return [line.strip() for line in handle if line.strip()]


def resolve_vid_list_path(vid_list: str) -> str:
    """A split-list path; a relative one is anchored at the repo root as the
    reference does (core/utils/create_dataloader.py:103-108)."""
    if os.path.isabs(vid_list):
        return vid_list
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, vid_list)
