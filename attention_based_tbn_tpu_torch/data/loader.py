"""Threaded, prefetching data loader that feeds the card.

Port of the JAX package's ``data/loader.py``. A thread pool
decodes samples (cv2 and numpy release the GIL), a producer thread collates
them into numpy batches, pads a ragged batch when ``pad_to`` asks for it,
and, with a CUDA ``device``, stages every array in pinned host memory and
copies it to the card on a copy stream without blocking, so decode and the
host-to-device copy of the next batches overlap the model's work on this
one. Visual streams travel as uint8 (4x fewer bytes); normalization runs
on the device (models/tbn.py).

Each item is ``(batch, targets, meta)``: ``meta["batch_size"]`` is the
true size of the global batch (rows from it on are padding),
``meta["global_indices"]`` the dataset indices of its true rows, plus uid /
vid_id / timestamps of this rank's rows. This is the contract the port's
``tools/train.py`` and ``tools/test.py`` read.

Several ranks (``shard=(rank, world)``; ``create_dataloader`` sets it from
``parallel/mesh``), as the JAX package's multi-host loader
(loader.py:102-120, 195-218): every rank walks the same global batch
order; each global batch is padded at the index level, by repeating its
first index, to a multiple of ``world * pad_to``, so the pad rows sit at
the tail of the global batch; each rank decodes its contiguous ``1/world``
slice. A sample's augmentation draws from ``(seed, epoch, index)``, so
what a rank decodes does not depend on the topology.

``tpu.pack_visual_host`` is accepted and does nothing: the JAX package's
column-paired visual layout feeds its TPU stem rewrite, and the port takes
the plain (B, N, H, W, C) layout.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import mesh
from .dataset import VideoDataset
from .records import read_vid_list, resolve_vid_list_path


def collate(samples: Sequence[Dict]) -> Tuple[Dict, Dict, Dict]:
    """Sample dicts -> (batch arrays, targets, metadata)."""
    batch: Dict = {}
    targets: Dict = {"class": {}}
    meta: Dict = {key: [s[field] for s in samples]
                  for key, field in (("uid", "uid"), ("vid_id", "vid_id"),
                                     ("start_time", "start_time"), ("stop_time", "stop_time"))}
    for key in ("RGB", "Flow", "Audio"):
        if key in samples[0]:
            batch[key] = np.stack([s[key] for s in samples])
    if samples[0].get("weights") is not None:
        batch["weights"] = np.stack([s["weights"] for s in samples])
    if samples[0].get("target_weights") is not None:
        targets["weights"] = np.stack([s["target_weights"] for s in samples])
    labels = [s["labels"] for s in samples]
    if isinstance(labels[0], dict):
        for key in labels[0]:
            targets["class"][key] = np.asarray([label[key] for label in labels], np.int32)
    else:
        targets["class"] = None  # an unlabelled test csv (S1/S2)
    return batch, targets, meta


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def pad_batch(batch: Dict, targets: Dict, total: int) -> Tuple[Dict, Dict]:
    """Every leading batch dimension padded to ``total`` rows with copies of
    the first sample. Metrics and results use the true batch size
    (``meta["batch_size"]``)."""

    def pad(x):
        x = np.asarray(x)
        if x.shape[0] >= total:
            return x
        return np.concatenate([x, np.repeat(x[:1], total - x.shape[0], axis=0)])

    return _tree_map(pad, batch), _tree_map(pad, targets)


class DataLoader:
    """Iterates (batch, targets, meta) with background decode, prefetch and,
    on a CUDA ``device``, pinned non-blocking copies to the card.
    ``batch_size`` is the global batch's; ``shard=(rank, world)`` gives this
    rank its slice of every global batch (``world`` must divide
    ``batch_size``); ``pad_to`` is the global device count."""

    def __init__(self, dataset: VideoDataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, seed: int = 0, prefetch: int = 2, device=None,
                 pad_to: int = 1, shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(int(num_workers), 1)
        self.seed = seed
        self.prefetch = max(int(prefetch), 1)
        self.device = None if device is None else torch.device(device)
        self.pad_to = max(int(pad_to), 1)
        self.shard = shard
        if shard is not None:
            index, count = shard
            if not 0 <= index < count:
                raise ValueError(f"shard {shard}: not (rank, world) with 0 <= rank < world")
            if batch_size % count:
                raise ValueError(f"{count} ranks must divide the global batch size "
                                 f"{batch_size}")
            # pad_to counts the global devices; each rank pads to its share
            self.pad_to = max(self.pad_to // count, 1)
        self.epoch = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            # tuple seeding: (seed, epoch) streams never collide
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def _batches(self) -> List[np.ndarray]:
        """The global batches' dataset indices, the same on every rank."""
        order = self._index_order()
        return [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]

    def local_indices(self, batch: np.ndarray) -> np.ndarray:
        """This rank's indices of a global batch: the batch padded (by
        repeating its first index) to a multiple of ``world * pad_to``, then
        the rank's contiguous ``1/world`` of it; the batch itself unsharded."""
        if self.shard is None:
            return batch
        index, count = self.shard
        chunk = count * self.pad_to
        padded = max(-(-len(batch) // chunk) * chunk, chunk)
        if len(batch) < padded:
            batch = np.concatenate([batch, np.repeat(batch[:1], padded - len(batch))])
        local = padded // count
        return batch[index * local:(index + 1) * local]

    def _assemble(self, samples, indices: np.ndarray, stream) -> Tuple[Dict, Dict, Dict, Any]:
        """One (batch, targets, meta) triple of this rank's ``samples`` of the
        global batch ``indices``, padded to the ``pad_to`` multiple and, on a
        card, copied there on ``stream``; the last item is the copy's CUDA
        event (None off the card)."""
        batch, targets, meta = collate(samples)
        meta["batch_size"] = len(indices)
        meta["global_indices"] = indices
        padded = -(-len(samples) // self.pad_to) * self.pad_to
        if padded != len(samples):
            batch, targets = pad_batch(batch, targets, padded)
        if self.device is None:
            return batch, targets, meta, None
        if self.device.type != "cuda":
            to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(self.device)  # noqa: E731
            return _tree_map(to, batch), _tree_map(to, targets), meta, None
        with torch.cuda.stream(stream):
            def to(x):
                host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                return host.to(self.device, non_blocking=True)

            batch, targets = _tree_map(to, batch), _tree_map(to, targets)
            event = torch.cuda.Event()
            event.record(stream)
        return batch, targets, meta, event

    def __iter__(self) -> Iterator[Tuple[Dict, Dict, Dict]]:
        batches = self._batches()
        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        on_card = self.device is not None and self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if on_card else None

        def sample_one(index):
            rng = np.random.default_rng((self.seed, self.epoch, int(index)))
            return self.dataset.sample(int(index), rng)

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(sample_one, self.local_indices(idx)))
                        out_queue.put(self._assemble(samples, idx, stream))
                out_queue.put(None)
            except BaseException as exc:  # decode errors surface in the consumer
                out_queue.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, targets, meta, event = item
                if event is not None:
                    # the model's stream waits for the copy, and the copied
                    # memory is not reused while that stream may read it
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for tree in (batch, targets):
                        _tree_map(lambda t: t.record_stream(current), tree)
                yield batch, targets, meta
        finally:
            stop.set()
            while True:  # drain so a blocked producer can exit
                try:
                    out_queue.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=60)


def create_dataloader(cfg, modality, mode: str = "train", device=None) -> DataLoader:
    """The reference's create_dataloader surface (core/utils/
    create_dataloader.py): val reads the train annotation file; batch size
    and split list per mode. With several ranks (``parallel/mesh``) the
    loader takes this rank's shard, padded to the world (the JAX package's
    loader.py:297-304)."""
    section = {"train": cfg.train, "val": cfg.val, "test": cfg.test}[mode]
    annotation_file = (cfg.train.annotation_file if mode in ("train", "val")
                       else cfg.test.annotation_file)
    if isinstance(annotation_file, (list, tuple)):
        annotation_file = annotation_file[0]
    vid_list = None
    if section.vid_list:
        vid_list = read_vid_list(resolve_vid_list_path(section.vid_list))
    dataset = VideoDataset(cfg, vid_list, annotation_file, modality, mode=mode)
    world = mesh.world_size()
    return DataLoader(dataset, batch_size=int(section.batch_size), shuffle=(mode == "train"),
                      num_workers=int(cfg.num_workers), seed=int(cfg.data.manual_seed),
                      prefetch=int(cfg.get_path("tpu.prefetch", 2) or 2), device=device,
                      pad_to=world, shard=(mesh.rank(), world) if world > 1 else None)
