"""Epic-Kitchens class metadata: verb / noun tables and action names.

Port of the JAX package's ``data/classes.py`` (reference
core/dataset/epic_class.py), read with the standard ``csv`` module:
``EPIC_verb_classes.csv`` / ``EPIC_noun_classes.csv`` give each class id
its canonical ``class_key`` and a stringified list of synonyms; a synonym
maps to its class id, and (verb, noun) names map to the "verb_id,noun_id"
action string that ``test.action_list`` filters on.
"""

from __future__ import annotations

import ast
import csv
import os
from typing import Dict, List, Optional

from .records import read_pickle


class EpicClasses:
    def __init__(self, annotation_dir: str):
        self.annotation_dir = annotation_dir
        self._class_keys: Dict[str, List[str]] = {}
        self._verb_ids = self._load("EPIC_verb_classes.csv", "verbs")
        self._noun_ids = self._load("EPIC_noun_classes.csv", "nouns")
        action_path = os.path.join(annotation_dir, "action_id_to_name.pkl")
        self.action_names = read_pickle(action_path) if os.path.exists(action_path) else None

    def _load(self, filename: str, list_col: str) -> Dict[str, int]:
        """{synonym: class id}; the first row naming a synonym wins, as the
        JAX package's query on the exploded table returns its first match."""
        with open(os.path.join(self.annotation_dir, filename), newline="") as handle:
            reader = csv.DictReader(handle)
            cols = list(reader.fieldnames or [])
            rows = list(reader)
        if "class_key" in cols:
            self._class_keys[list_col] = [r["class_key"] for r in rows]
        syn_name = next((c for c in cols if c in (list_col, "verbs", "nouns")), None)
        if syn_name is None:
            raise ValueError(f"No synonym column in {filename}: {cols}")
        ids: Dict[str, int] = {}
        for row in rows:
            value = row[syn_name]
            synonyms = ast.literal_eval(value) if value.startswith("[") else [value]
            for synonym in synonyms:
                ids.setdefault(str(synonym), int(row[cols[0]]))
        return ids

    def _keys_or_raise(self, list_col: str) -> List[str]:
        # the reference raises when the csv lacks class_key (epic_class.py
        # reads df.class_key unconditionally)
        if list_col not in self._class_keys:
            raise AttributeError(
                f"EpicClasses.{list_col}: the {list_col[:-1]} class csv in "
                f"{self.annotation_dir} has no 'class_key' column, so "
                "class-id-indexed names are unavailable"
            )
        return self._class_keys[list_col]

    @property
    def verbs(self) -> List[str]:
        """Class-id-indexed verb names (reference epic_class.py:12-18)."""
        return self._keys_or_raise("verbs")

    @property
    def nouns(self) -> List[str]:
        """Class-id-indexed noun names (reference epic_class.py:33-38)."""
        return self._keys_or_raise("nouns")

    def verb_id(self, verb: str) -> int:
        return self._verb_ids[verb]

    def noun_id(self, noun: str) -> int:
        return self._noun_ids[noun]

    def action_id_string(self, verb: str, noun: str) -> str:
        return f"{self.verb_id(verb)},{self.noun_id(noun)}"

    def action_name(self, action_id: int) -> Optional[str]:
        if self.action_names is None:
            return None
        return self.action_names[action_id]
