"""Data parallelism across cards: one process per card, under ``torchrun``.

Port of the JAX package's ``parallel/mesh.py``. The JAX package runs one
SPMD program over a 1-D ``data`` mesh, the batch sharded over it; XLA
inserts the reductions. Here each card has a process of its own, launched
by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``)::

    torchrun --nproc_per_node=N -m attention_based_tbn_tpu_torch.main train.enable=true ...

and the reductions are ``torch.distributed`` collectives. The contract is
the JAX package's: a global batch of B rows on N ranks gives the same
losses, gradients, parameters and BatchNorm statistics as one process, up
to reduction order, a ragged batch included (its pad rows at the tail of
the global batch):

* the loader gives each rank a contiguous 1/N slice of every global batch
  (``data/loader.py``, ``shard``);
* live BatchNorm sums its masked moments and count over the ranks
  (``models/layers.batch_norm_train``, through :func:`all_reduce_sum`);
* every loss mean divides by the global count of real rows, so a rank's
  loss is its share of the global mean (``models/losses.py``);
* the gradients are summed over the ranks before the clip
  (``parallel/optim.py``, :func:`all_reduce_flat_`);
* dropout and gumbel noise is drawn for the whole global batch from the
  generator every rank holds, and each rank keeps its rows
  (:func:`global_noise`), so the noise does not depend on the topology;
* predictions, labels and logged losses are summed to every rank
  (:func:`gather_rows`, :func:`all_reduce_`), as the JAX package's
  replicated outputs are.

The collectives ride ``torch.distributed``'s default process group, which
is process-wide. With one process every function here is the identity, and
the code that calls them runs as it did, bit for bit. Only ``all_reduce``
and ``barrier`` are used: gloo supports them on CUDA tensors, where it has
no ``all_gather``.

Backend: NCCL where every rank of a host has a card of its own; gloo on the
CPU and where ranks share a card (more ranks than visible cards, or a
repeated id in ``gpu_ids``), since NCCL refuses two ranks on one card. The
choice follows the topology, never a failure, and :meth:`DataMesh.describe`
says which it is.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
TORCHRUN = "torchrun --nproc_per_node={n} -m attention_based_tbn_tpu_torch.main ..."


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return default if value == "" else int(value)


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on rank 0, the rank that writes checkpoints, logs and results."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for with one process)."""
    if world_size() > 1:
        dist.barrier()


def topology() -> Tuple[int, int, int, int]:
    """(rank, world, local rank, local world): the process group's when
    one exists, else ``torchrun``'s environment; one process without
    either."""
    if world_size() > 1:
        world, own = world_size(), rank()
    else:
        world, own = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", own)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if not (0 <= own < world and 0 <= local_rank < local_world <= world):
        raise ValueError(f"inconsistent ranks: rank {own} of {world}, local rank "
                         f"{local_rank} of {local_world}")
    return own, world, local_rank, local_world


@dataclass(frozen=True)
class DataMesh:
    """This process's place in the 1-D ``data`` mesh: its rank among
    ``world`` ranks, its rank on its host, its device and the backend of
    the process group (None for one process)."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device
    backend: Optional[str]
    shared_card: bool = False

    @property
    def size(self) -> int:
        return self.world

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world}

    def is_primary(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        barrier()

    def describe(self) -> str:
        """The log line of the JAX package's run_trainer, with the backend."""
        line = (f"Mesh: {self.shape} over {self.size} device(s), {self.world} process(es), "
                f"backend {self.backend or 'none'}, this rank {self.rank} on {self.device}")
        if self.shared_card:
            line += f" ({self.local_world} ranks share the card: NCCL needs a card per rank)"
        return line


def _card(cfg, device: torch.device, local_rank: int, local_world: int
          ) -> Tuple[torch.device, bool]:
    """(this rank's card, whether ranks of this host share a card)."""
    ids = [int(i) for i in (cfg.get_path("gpu_ids", []) or [])] if cfg is not None else []
    if ids:
        if local_world == 1 and len(ids) > 1:
            raise ValueError(
                f"gpu_ids={ids} names {len(ids)} cards for one process; the port runs one "
                f"process per card: launch `{TORCHRUN.format(n=len(ids))}`")
        if len(ids) != local_world:
            raise ValueError(f"gpu_ids={ids} names {len(ids)} cards for the {local_world} "
                             "processes of this host: give one id per process")
        return torch.device("cuda", ids[local_rank]), len(set(ids)) < len(ids)
    if device.index is not None:  # the caller named the card
        return device, local_world > 1
    count = torch.cuda.device_count()
    if count == 0:
        return device, False  # resolve_device raises
    return torch.device("cuda", local_rank % count), local_world > count


def maybe_initialize_distributed(cfg=None, device="cuda", shared_card: bool = False
                                 ) -> Optional[str]:
    """Initialize the process group once, when ``tpu.multihost=true`` asks
    for it or ``torchrun``'s ``WORLD_SIZE`` is above 1 (the JAX package's
    rule, mesh.py:37-41, with torchrun's variables for its coordinator's).
    Returns the backend: NCCL for ranks with a card each, gloo on the CPU or
    a shared card; None for one process."""
    if dist.is_initialized():
        return dist.get_backend()
    want = bool(cfg.get_path("tpu.multihost", False)) if cfg is not None else False
    if not (want or _env_int("WORLD_SIZE", 1) > 1):
        return None
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
               if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"several processes were asked for, but {missing} are not set: "
                           f"launch with `{TORCHRUN.format(n='N')}`")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" and not shared_card else "gloo"
    dist.init_process_group(backend, init_method="env://", rank=_env_int("RANK", 0),
                            world_size=_env_int("WORLD_SIZE", 1))
    return backend


def make_mesh(cfg=None, device="cuda") -> DataMesh:
    """This process's :class:`DataMesh` (the JAX package's ``make_mesh``):
    reads and checks ``tpu.mesh.data`` (> 0: must equal the number of
    processes) and ``gpu_ids`` (one card per process of the host, rank
    ``LOCAL_RANK`` on ``gpu_ids[LOCAL_RANK]``), picks the card
    (``cuda:{LOCAL_RANK}``, shared round-robin when the host has fewer
    cards than processes), makes it the current device, and initializes
    the process group. ``device``: "cpu" or "cuda" (a named card is taken
    as given). Calling it again returns the same mesh."""
    device = torch.device(device)
    own, world, local_rank, local_world = topology()
    requested = int(cfg.get_path("tpu.mesh.data", -1) or -1) if cfg is not None else -1
    if requested > 0 and requested != world:
        raise ValueError(f"tpu.mesh.data={requested} but {world} process(es) run: launch "
                         f"`{TORCHRUN.format(n=requested)}` or leave tpu.mesh.data=-1")
    shared = False
    if device.type == "cuda":
        device, shared = _card(cfg, device, local_rank, local_world)
    device = resolve_device(device)
    backend = maybe_initialize_distributed(cfg, device, shared)
    return DataMesh(own, world, local_rank, local_world, device, backend, shared)


def shutdown() -> None:
    """Destroy the process group, if one was made."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class CollectiveTimer:
    """Time spent in this process's all-reduces while it is active
    (:func:`timed_collectives`): CUDA events around each one on a card,
    the host clock on the CPU (gloo's CPU collectives block)."""

    def __init__(self):
        self.calls = 0
        self._events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._host_s = 0.0

    def ms(self) -> float:
        if self._events:
            torch.cuda.synchronize()
        return self._host_s * 1e3 + sum(s.elapsed_time(e) for s, e in self._events)


_TIMERS: List[CollectiveTimer] = []


@contextlib.contextmanager
def timed_collectives() -> Iterator[CollectiveTimer]:
    """Time every all-reduce of the block (measurement only)."""
    timer = CollectiveTimer()
    _TIMERS.append(timer)
    try:
        yield timer
    finally:
        _TIMERS.remove(timer)


def _all_reduce(tensor: torch.Tensor) -> None:
    if not _TIMERS:
        dist.all_reduce(tensor)
        return
    timer = _TIMERS[-1]
    timer.calls += 1
    if tensor.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(tensor)
        end.record()
        timer._events.append((start, end))
    else:
        began = time.perf_counter()
        dist.all_reduce(tensor)
        timer._host_s += time.perf_counter() - began


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone(memory_format=torch.contiguous_format)
        _all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        _all_reduce(grad)
        return grad


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks, differentiable: its backward
    sums the incoming gradient over the ranks (the transpose of SPMD's
    psum: every rank's loss reads the sum). ``tensor`` itself for one
    process."""
    if world_size() == 1:
        return tensor
    return _AllReduceSum.apply(tensor)


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks in place (no gradient); returns it."""
    if world_size() > 1:
        _all_reduce(tensor)
    return tensor


def all_reduce_flat_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum every tensor over the ranks in place, through one flat buffer
    per (dtype, device): one collective each, not one per tensor."""
    if world_size() == 1:
        return
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        _all_reduce(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


# dtypes that both NCCL and gloo sum; others ride as float32 (exact for
# bf16 / fp16 / bool / uint8 values)
_WIRE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)


def gather_rows(tensor: torch.Tensor) -> torch.Tensor:
    """The global batch's rows on every rank, from each rank's contiguous
    slice (its leading dimension; every rank holds as many rows): a
    zero-filled global buffer, this rank's rows written in, summed over the
    ranks. Exact, since x + 0 = x, and built on all_reduce alone. ``tensor``
    itself for one process."""
    world = world_size()
    if world == 1:
        return tensor
    wire = tensor if tensor.dtype in _WIRE_DTYPES else tensor.float()
    rows = wire.shape[0]
    out = wire.new_zeros((world * rows,) + tuple(wire.shape[1:]))
    out[rank() * rows:(rank() + 1) * rows] = wire
    _all_reduce(out)
    return out.to(tensor.dtype)


def global_noise(shape: Sequence[int], draw: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """This rank's rows of ``draw(the global shape)``: the noise one process
    draws for the global batch, so that a dropout or gumbel draw does not
    depend on the topology and every rank's generator advances alike.
    ``shape``: this rank's, rows leading."""
    world = world_size()
    if world == 1:
        return draw(tuple(shape))
    rows = shape[0]
    return draw((world * rows,) + tuple(shape[1:]))[rank() * rows:(rank() + 1) * rows]


def row_mask(rows: int, true_batch: Optional[int], device) -> Optional[torch.Tensor]:
    """0/1 per row of this rank's ``rows``: the rows of the global batch
    before ``true_batch`` are real, the rest padding (None: every row is
    real)."""
    if true_batch is None:
        return None
    start = rank() * rows
    return (torch.arange(start, start + rows, device=device) < true_batch).float()
