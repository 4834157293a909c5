"""Pattern-table TreeSHAP on the GPU: the CUDA kernel of
``models/tree/shap.flat_shap_tab``.

``flat_shap_tab_kernel(tables, ctab, X, enum_mask)`` computes one
virtual-tree group's [rows, F+1] contributions. It dispatches on the
tensors' device:

- CPU tensors take the plain torch version (``flat_shap_tab_plain``);
- CUDA tensors launch the hand-written kernel in
  ``csrc/shap_tab.cu`` (one thread per row; see the note at the top of
  that file), or raise. There is no fallback and no switch.

The kernel is built at first use by ``ops/_build.py`` (nvcc for
``sm_90a``, a plain C entry bound with ``ctypes``, cached under
``build/kernels/`` by a hash of the source). ``build()`` does that
explicitly and returns the seconds it took.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..models.tree.shap import ShapTables, canonical_xt
from ..models.tree.shap import flat_shap_tab as flat_shap_tab_plain
from ._build import KernelLib

__all__ = ["flat_shap_tab_kernel", "flat_shap_tab_plain", "build", "LIB"]

_MAX_DEPTH = 14           # pattern tables exist only for D <= 14

LIB = KernelLib("shap_tab", {
    "shap_tab_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_void_p]})
build = LIB.build
_count_lock = threading.Lock()      # handler and batcher threads launch


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


def flat_shap_tab_kernel(tables: ShapTables, ctab: torch.Tensor,
                         X: torch.Tensor, enum_mask: torch.Tensor
                         ) -> torch.Tensor:
    """[rows, F] × ShapTables × pattern table -> [rows, F+1] phi for
    one virtual-tree group (the contract of ``flat_shap_tab``)."""
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
    if not 1 <= D <= _MAX_DEPTH:
        raise ValueError(f"group depth {D} outside [1, {_MAX_DEPTH}]")
    dev = X.device
    _check("enum_mask", enum_mask, torch.bool, (F,), dev)
    _check("feat", tables.feat, torch.int32, (T, L, D), dev)
    _check("lo", tables.lo, torch.float32, (T, L, D), dev)
    _check("hi", tables.hi, torch.float32, (T, L, D), dev)
    _check("na_ok", tables.na_ok, torch.bool, (T, L, D), dev)
    _check("bias", tables.bias, torch.float32, (T,), dev)
    _check("ctab", ctab, torch.float32, (T, L, D, 1 << D), dev)
    lib = LIB.load()
    # xt is freed on return while the kernel may still run: the caching
    # allocator hands its memory out again only in this stream's order
    xt = canonical_xt(X, enum_mask)                    # [F, rows]
    phi_t = torch.zeros((F + 1, rows), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.shap_tab_launch(
        tables.feat.data_ptr(), tables.lo.data_ptr(),
        tables.hi.data_ptr(), tables.na_ok.data_ptr(),
        tables.bias.data_ptr(), xt.data_ptr(), ctab.data_ptr(),
        phi_t.data_ptr(), T, L, D, F, rows, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"shap_tab kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        flat_shap_tab_kernel.launches += 1
    return phi_t.T


flat_shap_tab_kernel.launches = 0
