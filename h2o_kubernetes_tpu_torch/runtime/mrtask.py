"""MRTask on the row group: a per-rank map, then a collective reduce.

The JAX package's ``doall(fn, *cols)`` runs ``fn`` on each device's
row shard inside ``shard_map`` and reduces the returned pytree with
``psum``/``pmin``/``pmax``/``pmean``/``all_gather``. The port's ranks
are processes: ``doall`` runs ``map_fn`` on this rank's shard and
reduces each leaf across the group (``runtime/mesh.py``) with the
``torch.distributed`` collective of its kind. At world size 1 every
reduction is the identity and no collective runs.

Reduce kinds (a bare string applies to every leaf, or a pytree of them
matching the result): ``sum``, ``min``, ``max``, ``mean`` (the sum over
ranks divided by the world size, as ``pmean``), ``concat`` (the ranks'
leaves stacked along axis 0 in rank order, as ``all_gather(...,
tiled=True)``; the leaves may differ in length) and ``none`` (this
rank's leaf as it is).

Every rank receives the same bits: the ring all-reduce of NCCL and of
gloo reduce each element in one order and then broadcast it.

Gloo takes CUDA tensors for some collectives and not for others
(``all_gather`` among them), so on the gloo backend a CUDA tensor
crosses through host memory for every kind: it is copied to the CPU,
reduced there and copied back. NCCL reduces on the card.

A collective that fails (a rank died, the transport broke) marks this
rank unhealthy and raises ``ClusterHealthError``: the group is locked
at formation and a lost rank ends it, as the JAX package's dead mesh
does.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable

import numpy as np
import torch

from .mesh import RowGroup, global_mesh

__all__ = ["doall", "allreduce", "gather_rows", "shard_rows",
           "padded_len", "shard_bounds", "COLLECTIVES", "reset_collectives",
           "set_collective_timing"]

_KINDS = ("sum", "min", "max", "mean", "concat", "none")

# per call site of a collective: calls, payload bytes and (with timing
# on) wall seconds including the staging copies
COLLECTIVES: dict[str, dict[str, float]] = {}
_TIMING = {"on": False}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def set_collective_timing(on: bool) -> None:
    """Time each collective: the rank's device is synchronized before
    and after it, so the seconds are the collective's own. Off by
    default (it serializes the stream)."""
    _TIMING["on"] = bool(on)


def _coll_device(g: RowGroup, t: torch.Tensor) -> torch.device:
    if g.backend == "gloo":
        return torch.device("cpu")
    return g.device if g.device is not None else t.device


def _collective(g: RowGroup, site: str, nbytes: int, fn):
    """Run one collective ``fn`` under the group's failure rule and
    account for it under ``site``."""
    from .health import ClusterHealthError, mark_unhealthy

    timing = _TIMING["on"]
    dev = g.device
    if timing and dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — a broken group is fatal
        mark_unhealthy(f"row group collective failed: {e!r}")
        raise ClusterHealthError(
            f"row group collective failed on rank {g.rank}: {e} — the "
            "group is lost; restart every rank") from e
    if timing and dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    st = COLLECTIVES.setdefault(site, {"calls": 0, "bytes": 0,
                                       "seconds": 0.0})
    st["calls"] += 1
    st["bytes"] += nbytes
    st["seconds"] += time.perf_counter() - t0
    return out


def allreduce(x: torch.Tensor, op: str = "sum",
              group: RowGroup | None = None,
              site: str = "doall") -> torch.Tensor:
    """``x`` reduced across the group by ``op`` (one of the reduce
    kinds), as a new tensor on ``x``'s device; ``x`` itself is never
    written. Boolean tensors reduce as int32 and come back bool."""
    import torch.distributed as dist

    g = group or global_mesh()
    if op not in _KINDS:
        raise ValueError(f"unknown reduce kind {op!r} (one of {_KINDS})")
    if g.world_size == 1 or op == "none":
        return x
    if op == "concat":
        return gather_rows(x, g, site)
    src = x.to(torch.int32) if x.dtype == torch.bool else x
    t = src.detach().to(_coll_device(g, x), copy=True).contiguous()
    red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
    _collective(g, site, t.numel() * t.element_size(),
                lambda: dist.all_reduce(t, op=red, group=g.pg))
    if op == "mean":
        t = t / g.world_size
    t = t.to(x.device)
    return t.bool() if x.dtype == torch.bool else t


def gather_rows(x: torch.Tensor, group: RowGroup | None = None,
                site: str = "gather") -> torch.Tensor:
    """Every rank's ``x`` stacked along axis 0 in rank order (the
    ranks' row counts may differ), on ``x``'s device."""
    import torch.distributed as dist

    g = group or global_mesh()
    if g.world_size == 1:
        return x
    cdev = _coll_device(g, x)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=cdev)
    ns = [torch.empty_like(n) for _ in range(g.world_size)]
    _collective(g, site, 8, lambda: dist.all_gather(ns, n, group=g.pg))
    ns = [int(v) for v in ns]
    m = max(ns)
    t = torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=cdev)
    t[: x.shape[0]] = x.detach().to(cdev)
    parts = [torch.empty_like(t) for _ in range(g.world_size)]
    _collective(g, site, t.numel() * t.element_size() * g.world_size,
                lambda: dist.all_gather(parts, t, group=g.pg))
    return torch.cat([p[:k] for p, k in zip(parts, ns)]).to(x.device)


def _tree_map(fn, tree, reds):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, reds[k] if isinstance(reds, dict)
                             else reds) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        rs = reds if isinstance(reds, (list, tuple)) else \
            [reds] * len(tree)
        return type(tree)(_tree_map(fn, v, r) for v, r in zip(tree, rs))
    return fn(tree, reds)


def doall(map_fn: Callable[..., Any], *cols: torch.Tensor,
          reduce: Any = "sum", group: RowGroup | None = None) -> Any:
    """``map_fn`` on this rank's row shards of ``cols``, each leaf of
    its result (a tensor, or a dict/list/tuple of them) reduced across
    the group by its kind (``reduce``: a kind, or a matching pytree of
    kinds). Every rank gets the reduced result, as ``MRTask.getResult``
    returns the reduced task.

    The health gate runs first (``require_healthy``, no ``train.step``
    fault consumed), then the ``mrtask.doall`` fault point; the map and
    its collectives run under the circuit breaker and the device
    dispatch guard, so a device error or a lost rank surfaces as
    ``ClusterHealthError``."""
    from . import faults
    from .health import device_dispatch, require_healthy
    from .lifecycle import breaker_guard

    require_healthy(fault_site=None)
    faults.fire("mrtask.doall")
    g = group or global_mesh()
    with breaker_guard("doall dispatch"), \
            device_dispatch("doall dispatch"):
        out = map_fn(*cols)
        return _tree_map(lambda leaf, r: allreduce(leaf, r, g), out,
                         reduce)


@functools.lru_cache(maxsize=None)
def padded_len(n: int, shards: int) -> int:
    return ((n + shards - 1) // shards) * shards


def shard_bounds(n: int, group: RowGroup | None = None
                 ) -> tuple[int, int, int]:
    """(lo, hi, m) of this rank's shard of ``n`` rows: it holds padded
    rows [lo, hi) = [rank·m, (rank+1)·m), m = padded_len / world."""
    g = group or global_mesh()
    m = padded_len(n, g.world_size) // g.world_size
    return g.rank * m, (g.rank + 1) * m, m


def shard_rows(x, pad_value=None, group: RowGroup | None = None,
               device=None) -> torch.Tensor:
    """This rank's row shard of the host array ``x`` (every rank holds
    the same ``x``), as a tensor on ``device``: rows padded to a
    multiple of the world size (NaN for floats, -1 for signed integers,
    0 otherwise, unless ``pad_value``), rank r holding padded rows
    [r·m, (r+1)·m). At world size 1, ``x`` itself."""
    g = group or global_mesh()
    x = np.asarray(x)
    n = x.shape[0]
    lo, hi, _ = shard_bounds(n, g)
    part = x[lo: min(hi, n)]
    if hi > n:
        if pad_value is None:
            kind = x.dtype.kind
            pad_value = np.nan if kind == "f" else -1 if kind == "i" else 0
        pad = np.full((hi - max(lo, n),) + x.shape[1:], pad_value,
                      dtype=x.dtype)
        part = np.concatenate([part, pad], axis=0)
    return torch.as_tensor(np.ascontiguousarray(part), device=device)
