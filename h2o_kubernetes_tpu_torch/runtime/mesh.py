"""The row group: the port's counterpart of the JAX package's device mesh.

The JAX package shards every Frame column over a mesh's ROWS axis and
reduces inside ``shard_map`` with XLA collectives (``lax.psum``,
``pmean``, ``pmax``, ``all_gather``). The port runs one process per
rank instead: the ranks share one ``torch.distributed`` process group,
each keeps its own padded row shard on its own device, and the
reductions are that group's collectives (``runtime/mrtask.py``). NCCL
is the default when a rank's device is a CUDA card of its own, gloo
when the ranks are CPU processes; the caller may pass either (two
ranks sharing one card must pass ``backend="gloo"``: NCCL refuses two
ranks on one device).

World size 1 is a group of one with no process group: every reduction
is the identity and no collective runs, so a single process computes
exactly as it did before groups existed.

The group is formed once, by ``initialize_distributed`` from the
operator's ``H2O_TPU_COORDINATOR`` / ``H2O_TPU_NUM_PROCESSES`` /
``H2O_TPU_PROCESS_ID`` contract (the JAX package's three variables) or
from arguments, and is immutable for the process's life, as the JAX
package's cloud locks at formation. The COLS axis (the JAX package's feature sharding of GLM's Gram) is not
ported.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ROWS", "RowGroup", "global_mesh", "set_global_mesh",
           "use_mesh", "n_row_shards", "rank", "initialize_distributed",
           "single_process_only"]

ROWS = "rows"
# every collective of a group is bounded by this
_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class RowGroup:
    """One rank's view of the row group: its rank, the world size, its
    device (None: whatever device the caller's data is on), the
    collective backend and the ``torch.distributed`` process group
    (None at world size 1)."""

    rank: int = 0
    world_size: int = 1
    device: torch.device | None = None
    backend: str | None = None
    pg: Any = None

    @property
    def shape(self) -> dict:
        """The JAX mesh's ``shape`` mapping, ROWS axis only."""
        return {ROWS: self.world_size}


_SINGLE = RowGroup()
_global: RowGroup = _SINGLE


def global_mesh() -> RowGroup:
    """This process's row group (a group of one until
    ``initialize_distributed`` forms one)."""
    return _global


def set_global_mesh(group: RowGroup) -> None:
    global _global
    _global = group


@contextlib.contextmanager
def use_mesh(group: RowGroup):
    """Temporarily swap the process-wide row group (not thread-safe)."""
    global _global
    prev = _global
    _global = group
    try:
        yield group
    finally:
        _global = prev


def n_row_shards(group: RowGroup | None = None) -> int:
    return (group or _global).world_size


def rank(group: RowGroup | None = None) -> int:
    return (group or _global).rank


def single_process_only(what: str) -> None:
    """Refuse ``what`` on a row group of more than one rank: the port
    runs it in one process only so far (ROADMAP.md, Queue 1)."""
    if _global.world_size > 1:
        raise NotImplementedError(
            f"{what} on a row group of {_global.world_size} ranks is not "
            "ported yet (ROADMAP.md Queue 1, the paths item 14 left "
            "single-process)")


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device=None) -> RowGroup:
    """Form the row group and make it this process's; returns it.

    ``coordinator`` (``host:port`` or ``tcp://host:port``, rank 0
    listens there), ``num_processes`` and ``process_id`` default to
    ``H2O_TPU_COORDINATOR``, ``H2O_TPU_NUM_PROCESSES`` and
    ``H2O_TPU_PROCESS_ID``. With no coordinator, or one process, it
    forms nothing and returns the current group. ``device``: the rank's
    device (default ``cuda:{process_id mod cards}``, made the current
    card; ``"cpu"`` for CPU ranks). ``backend``: ``"nccl"`` or
    ``"gloo"``, by default NCCL for a CUDA device and gloo for the CPU.
    A process that already belongs to a group keeps it."""
    from .backend import resolve_device

    coordinator = coordinator or os.environ.get("H2O_TPU_COORDINATOR")
    if coordinator is None:
        return _global
    num_processes = num_processes or int(
        os.environ.get("H2O_TPU_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("H2O_TPU_PROCESS_ID", "0"))
    if num_processes <= 1 or _global.world_size > 1:
        return _global             # nothing to form, or formed already
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for this rank; pass "
                "device='cpu' to form a group of CPU ranks")
        device = f"cuda:{process_id % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    torch.distributed.init_process_group(
        backend, init_method=init, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    group = RowGroup(rank=process_id, world_size=num_processes,
                     device=dev, backend=backend,
                     pg=torch.distributed.group.WORLD)
    set_global_mesh(group)
    return group

