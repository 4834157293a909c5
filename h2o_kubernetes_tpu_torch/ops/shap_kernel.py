"""Pattern-table TreeSHAP on the GPU: the CUDA kernel of
``models/tree/shap.flat_shap_tab``.

``flat_shap_tab_kernel(tables, ctab, X, enum_mask)`` computes one
virtual-tree group's [rows, F+1] contributions. It dispatches on the
tensors' device:

- CPU tensors take the plain torch version (``flat_shap_tab_plain``);
- CUDA tensors launch the hand-written kernel in
  ``csrc/shap_tab.cu`` (one thread per row; see the note at the top of
  that file), or raise. There is no fallback and no switch.

The kernel is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry, loaded with ``ctypes``, at first use,
into ``build/kernels/`` under the checkout, keyed by a hash of the
source. ``build()`` does that explicitly and returns the seconds it
took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..models.tree.shap import ShapTables, canonical_xt
from ..models.tree.shap import flat_shap_tab as flat_shap_tab_plain

__all__ = ["flat_shap_tab_kernel", "flat_shap_tab_plain", "build",
           "SOURCE"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "shap_tab.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]
_MAX_DEPTH = 14           # pattern tables exist only for D <= 14

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()      # handler and batcher threads launch
BUILD_LOG = ""            # nvcc's output of the last build (ptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernel cannot "
                       "be built")


def _load():
    """Build (once per source hash) and bind the kernel library."""
    global _lib, BUILD_LOG
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
        so = _BUILD_DIR / f"shap_tab-{tag}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                                str(SOURCE)], capture_output=True,
                               text=True)
            BUILD_LOG = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed building {SOURCE.name}:"
                                   f"\n{BUILD_LOG}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.shap_tab_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def build() -> float:
    """Compile and load the kernel library now; returns the seconds."""
    t0 = time.perf_counter()
    _load()
    return time.perf_counter() - t0


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
    lib = _load()
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
