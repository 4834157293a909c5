"""Pattern-table TreeSHAP on the GPU: the CUDA kernel of
``models/tree/shap.flat_shap_tab``.

``flat_shap_tab_kernel(tables, ctab, X, enum_mask, slots=None)`` computes
one virtual-tree group's [rows, F+1] contributions. It dispatches on the
tensors' device:

- CPU tensors take the plain torch version (``flat_shap_tab_plain``);
- CUDA tensors launch the hand-written kernel in ``csrc/shap_tab.cu``
  (see the note at the top of that file), or raise. There is no
  fallback and no switch.

``shap_plan(F, T, L, D, rows)`` (plain Python, tested on the CPU) picks
the launch by shape, in one of three variants:

- ``staged``: a block of R rows keeps their phi [R, F+1] and X rows in
  shared memory, and each virtual tree's slot records and ctab[t] slice
  are copied into shared memory, in two buffers where two fit (the next
  tree's copy overlaps this tree's work);
- ``unstaged``: the same, with records and ctab read through the
  read-only path, where one tree's slice does not fit beside phi and X
  (D >= 8 at 32 leaves);
- ``global_phi``: X^T and phi^T in device memory, one thread per row,
  where phi and X of even 32 rows do not fit one block (very wide F).

R is chosen from the shared memory the variant needs: the plan keeps as
many rows' warps resident on each SM as the batch gives, up to
``_SAT_WARPS``.

``pack_slots(tables)`` packs each path slot's feature offsets, lo, hi
and na_ok into one 16-byte record; the serving path builds it once per model
(``Model._contrib_prepare``) and passes it in, other callers let the
wrapper pack per call.

The kernel is built at first use by ``ops/_build.py`` (nvcc for
``sm_90a``, a plain C entry bound with ``ctypes``, cached under
``build/kernels/`` by a hash of the source). ``build()`` does that
explicitly and returns the seconds it took.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass

import torch

from ..models.tree.shap import ShapTables
from ..models.tree.shap import flat_shap_tab as flat_shap_tab_plain
from ._build import KernelLib

__all__ = ["flat_shap_tab_kernel", "flat_shap_tab_plain", "pack_slots",
           "shap_plan", "ShapPlan", "build", "LIB", "LAUNCHES", "VARIANTS",
           "BLOCK_SMEM", "reset_launches"]

_MAX_DEPTH = 14           # pattern tables exist only for D <= 14
# the H100's shared memory: per block (opt-in) and per SM, and what the
# runtime reserves per resident block
BLOCK_SMEM = 232_448
_SM_SMEM = 233_472
_BLOCK_RESERVED = 1024
_SMS = 132
_THREADS_PER_SM = 2048
_BLOCKS_PER_SM = 32
_ROWS_PER_BLOCK = (256, 128, 64, 32)    # csrc/shap_tab.cu kMaxThreads
_GLOBAL_THREADS = 128
# resident warps per SM past which more did not add throughput on an
# H100 (tools/torch_shap_sweep.py --plans: at the serving model's depth-5
# group, plans with 12-16 warps per SM ran within 6% of each other, with
# 4-8 warps 1.4-1.8x slower)
_SAT_WARPS = 16

VARIANTS = ("staged", "unstaged", "global_phi")
LIB = KernelLib("shap_tab", {
    "shap_tab_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
    + [ctypes.c_void_p]})
build = LIB.build
# launches by variant; flat_shap_tab_kernel.launches is their total.
# Handler and batcher threads launch, hence the lock.
LAUNCHES = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        LAUNCHES.update(dict.fromkeys(VARIANTS, 0))
        flat_shap_tab_kernel.launches = 0


@dataclass(frozen=True)
class ShapPlan:
    """One launch of the kernel: ``threads`` rows per block, one per
    thread; ``stages`` ctab[t] buffers in shared memory (0: read through
    the read-only path), each ``buf_floats`` floats (records, then the
    slice); ``smem_bytes`` of dynamic shared memory per block."""

    variant: str
    threads: int
    stages: int
    buf_floats: int
    smem_bytes: int
    blocks: int
    blocks_per_sm: int


def _blocks_per_sm(smem: int, threads: int) -> int:
    return min(_SM_SMEM // (smem + _BLOCK_RESERVED),
               _THREADS_PER_SM // threads, _BLOCKS_PER_SM)


def _score(p: ShapPlan) -> tuple:
    """Resident warps over the card (each SM's capped at _SAT_WARPS) for
    the batch's blocks; then more stage buffers, then more rows per
    block (fewer table copies)."""
    busy = min(_SMS, p.blocks)
    per_sm = min(p.blocks_per_sm, -(-p.blocks // _SMS))
    warps = min(_SAT_WARPS, per_sm * p.threads // 32)
    return busy * warps, p.stages, p.threads


def _row_floats(F: int) -> int:
    """Shared floats per row: its X [F | 1] and phi [(F+1) | 1] (odd row
    strides, so a warp's 32 rows fall on 32 banks)."""
    return (F | 1) + ((F + 1) | 1)


@functools.lru_cache(maxsize=1024)      # called once per group and batch
def shap_plan(F: int, T: int, L: int, D: int, rows: int) -> ShapPlan:
    """The launch for one group of T virtual trees of L leaves and depth
    D over ``rows`` rows of F features. Raises on what no variant takes.

    ``staged`` wherever one tree's slice fits beside phi and X of 32 rows,
    ``unstaged`` where only phi and X fit, else ``global_phi``; among the
    fitting (rows per block, stage buffers) the one with the best
    ``_score``."""
    if not 1 <= D <= _MAX_DEPTH:
        raise ValueError(f"group depth {D} outside [1, {_MAX_DEPTH}]")
    if F < 1 or T < 1 or L < 1 or rows < 0:
        raise ValueError(f"no launch for F={F} T={T} L={L} rows={rows}")
    LD = L * D
    if LD << D >= 1 << 31:
        raise ValueError(f"ctab[t] of L={L} D={D} exceeds 2^31 entries")
    buf = -(-(4 * LD + (LD << D)) // 4) * 4     # 16-byte multiple
    fits = []
    for R in _ROWS_PER_BLOCK:
        onchip = 4 * R * _row_floats(F)
        for stages in (2, 1, 0):
            smem = onchip + 4 * stages * buf
            if smem <= BLOCK_SMEM:
                fits.append(ShapPlan(
                    "staged" if stages else "unstaged", R, stages,
                    buf if stages else 0, smem, -(-rows // R),
                    _blocks_per_sm(smem, R)))
    pool = [p for p in fits if p.stages] or fits
    if pool:
        return max(pool, key=_score)
    return ShapPlan("global_phi", _GLOBAL_THREADS, 0, 0, 0,
                    -(-rows // _GLOBAL_THREADS),
                    _THREADS_PER_SM // _GLOBAL_THREADS)


def pack_slots(tables: ShapTables) -> torch.Tensor:
    """[T, L, D, 4] int32 slot records on the tables' device, the
    kernel's int4: the feature's byte offset in a row of X (0 for a
    padding slot), the f32 bits of lo and of hi, and (feature << 2) |
    na_ok, or -1 for a padding slot. Raises where a leaf names one
    feature in two slots: the kernel updates a leaf's features
    independently (the table builders merge a path's splits on one
    feature into one slot)."""
    feat = tables.feat.to(torch.int32)
    srt = feat.sort(dim=-1).values
    if bool(((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0)).any()):
        raise ValueError("a leaf of the path tables names one feature in "
                         "two slots")
    w = torch.where(feat < 0, -1, feat * 4 + tables.na_ok.to(torch.int32))
    return torch.stack([feat.clamp(min=0) * 4, tables.lo.view(torch.int32),
                        tables.hi.view(torch.int32), w],
                       dim=-1).contiguous()


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(tables: ShapTables, ctab: torch.Tensor, X: torch.Tensor,
            enum_mask: torch.Tensor, slots: torch.Tensor,
            plan: ShapPlan) -> torch.Tensor:
    """Launch one plan on checked CUDA tensors; returns [rows, F+1]."""
    rows, F = X.shape
    T, L, D = tables.feat.shape
    dev = X.device
    if plan.variant == "global_phi":
        # X^T and phi^T in device memory: a warp's accesses coalesce. The
        # transposed copy is freed on return while the kernel may still
        # run: the caching allocator hands its memory out again only in
        # this stream's order.
        x = X.T.contiguous()
        buf = torch.zeros((F + 1, rows), dtype=torch.float32, device=dev)
        out = buf.T
    else:
        x = X
        buf = out = torch.empty((rows, F + 1), dtype=torch.float32,
                                device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = LIB.load().shap_tab_launch(
        slots.data_ptr(), tables.bias.data_ptr(), ctab.data_ptr(),
        x.data_ptr(), enum_mask.data_ptr(), buf.data_ptr(), T, L, D, F,
        rows, VARIANTS.index(plan.variant), plan.threads, plan.stages,
        plan.buf_floats, plan.smem_bytes, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"shap_tab kernel launch failed ({plan}): CUDA "
                           f"error {err}")
    return out


def flat_shap_tab_kernel(tables: ShapTables, ctab: torch.Tensor,
                         X: torch.Tensor, enum_mask: torch.Tensor,
                         slots: "torch.Tensor | None" = None
                         ) -> torch.Tensor:
    """[rows, F] × ShapTables × pattern table -> [rows, F+1] phi for
    one virtual-tree group (the contract of ``flat_shap_tab``).
    ``slots`` is ``pack_slots(tables)``, packed here when not given."""
    if X.device.type == "cpu":
        return flat_shap_tab_plain(tables, ctab, X, enum_mask)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dim() != 2:
        raise ValueError(f"X must be [rows, F], got {tuple(X.shape)}")
    rows, F = X.shape
    if X.dtype != torch.float32:
        raise TypeError(f"X must be float32, got {X.dtype}")
    T, L, D = tables.feat.shape
    plan = shap_plan(F, T, L, D, rows)
    dev = X.device
    _check("enum_mask", enum_mask, torch.bool, (F,), dev)
    _check("feat", tables.feat, torch.int32, (T, L, D), dev)
    _check("lo", tables.lo, torch.float32, (T, L, D), dev)
    _check("hi", tables.hi, torch.float32, (T, L, D), dev)
    _check("na_ok", tables.na_ok, torch.bool, (T, L, D), dev)
    _check("bias", tables.bias, torch.float32, (T,), dev)
    _check("ctab", ctab, torch.float32, (T, L, D, 1 << D), dev)
    if slots is None:
        slots = pack_slots(tables)
    _check("slots", slots, torch.int32, (T, L, D, 4), dev)
    if slots.data_ptr() % 16:
        raise ValueError("slots must be 16-byte aligned (the kernel reads "
                         "int4 records)")
    if rows == 0:
        return torch.zeros((0, F + 1), dtype=torch.float32, device=dev)
    # a copy made by contiguous() is freed on return while the kernel may
    # still run: the caching allocator hands its memory out again only in
    # this stream's order
    out = _launch(tables, ctab, X.contiguous(), enum_mask, slots, plan)
    with _count_lock:
        LAUNCHES[plan.variant] += 1
        flat_shap_tab_kernel.launches += 1
    return out


flat_shap_tab_kernel.launches = 0
