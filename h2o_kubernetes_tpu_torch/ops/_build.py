"""Build and bind the port's CUDA kernels: ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.

A library is built at first use from the checkout's own source into
``build/kernels/`` under the checkout, one cache entry per hash of the
source and the flags, so an edited source never loads a stale build.
``KernelLib.build_log`` keeps nvcc's output (``-Xptxas -v``: registers,
shared memory, spills) of the build this process ran, "" on a hit.
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

__all__ = ["KernelLib", "CSRC"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]


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


class KernelLib:
    """One ``csrc/<name>.cu`` library. ``entries`` maps each C entry
    point to its ctypes argtypes (``c_void_p`` for pointers and the
    stream); every entry returns an int CUDA error code."""

    def __init__(self, name: str, entries: dict[str, list]):
        self.source = CSRC / f"{name}.cu"
        self._entries = entries
        self._lib = None
        self._lock = threading.Lock()
        self.build_log = ""

    def load(self) -> ctypes.CDLL:
        """Build (once per source hash) and bind the library."""
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is not None:
                return self._lib
            src = self.source.read_bytes()
            tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()
                                 ).hexdigest()[:16]
            so = _BUILD_DIR / f"{self.source.stem}-{tag}.so"
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                r = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                                    str(self.source)], capture_output=True,
                                   text=True)
                self.build_log = r.stdout + r.stderr
                if r.returncode != 0:
                    raise RuntimeError(f"nvcc failed building "
                                       f"{self.source.name}:\n"
                                       f"{self.build_log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            for fn_name, argtypes in self._entries.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
            return lib

    def build(self) -> float:
        """Compile and load the library now; returns the seconds."""
        t0 = time.perf_counter()
        self.load()
        return time.perf_counter() - t0
