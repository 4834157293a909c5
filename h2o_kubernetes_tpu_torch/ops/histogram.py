"""The per-level histogram build of the tree learners — their hot op.

Per tree level every live row adds (g·w, h·w, w) — or (g·w, w) under a
unit hessian — into cell [node, feature, bin] of ``hist[n_nodes, F, B,
C]``. Forests and multinomial models grow K trees per step against one
binned matrix, so the build is batched over trees:
``build_histogram_batched(binned, rel [K, rows], vals [K, rows, C],
n_nodes, n_bins) -> [K, n_nodes, F, B, C]`` (the JAX package's
``_hist_vmappable`` under ``vmap``, kernel B3). The single-tree
``build_histogram_kernel`` is its K=1 call. Both dispatch on the
tensors' device:

- CPU tensors take the plain torch version (``histogram_plain``: one
  ``index_add_`` per feature over ``rel·B + bin``, dead rows sent to a
  junk segment — the JAX package's ``_hist_segment``; batched, tree k's
  live rows are relabelled to nodes ``k·n_nodes + rel`` and the K row
  streams are concatenated against the binned matrix repeated K times,
  the JAX package's vmap rule);
- CUDA tensors launch the hand-written kernel in ``csrc/histogram.cu``
  (kernels B1, B2 and B3 of the JAX package as one kernel; see the note
  at the top of that file), or raise. There is no fallback and no
  switch.

``binned`` is FEATURE-MAJOR [F, rows]: uint8 bin codes for training,
int16 for the 4096-bin AUC histogram. The kernel keeps a CTA's slice of
the [K·n_nodes·B, C] histogram in shared memory: the whole of it while
``K·n_nodes·B·C·4 <= SHARED_HIST_BYTES`` (shared mode), else the
node·bin axis is cut into ranges that fit, one per CTA (split mode).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ._build import KernelLib

__all__ = ["build_histogram", "build_histogram_kernel",
           "build_histogram_batched", "histogram_plain",
           "histogram_batched_plain", "expand_unit_hess", "hist_mode",
           "build", "LIB", "LAUNCHES", "BATCHED_LAUNCHES",
           "SHARED_HIST_BYTES"]

# shared memory one block can opt into on Hopper (232,448 bytes): the
# shared/split threshold. At C=3, B=256 a level fits up to 64 nodes.
SHARED_HIST_BYTES = 227 * 1024
_ROW_TILE = 256           # rows per CTA are at least this many
_CTAS_PER_SM = 4          # row blocks are sized to fill the card this deep

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
LIB = KernelLib("histogram", {"hist_launch_u8": _ARGS,
                              "hist_launch_i16": _ARGS})
build = LIB.build
_count_lock = threading.Lock()
# kernel launches by mode; module globals, so a caller that wraps
# build_histogram_kernel still reads and resets the wrapper's own count.
# BATCHED_LAUNCHES counts the launches over K > 1 trees (B3), which are
# also in LAUNCHES.
LAUNCHES = {"shared": 0, "split": 0}
BATCHED_LAUNCHES = {"shared": 0, "split": 0}
_sm_count: dict[int, int] = {}


def histogram_plain(binned: torch.Tensor, rel: torch.Tensor,
                    vals: torch.Tensor, n_nodes: int, n_bins: int
                    ) -> torch.Tensor:
    """[F, rows] codes + [rows] rel (-1 dead) + [rows, C] vals ->
    [n_nodes, F, B, C] in vals' dtype: one ``index_add_`` per feature
    into [(n_nodes + 1)·B, C], dead rows into the junk node n_nodes."""
    F = binned.shape[0]
    C = vals.shape[1]
    seg_node = torch.where(rel >= 0, rel, n_nodes).long() * n_bins
    out = torch.empty((F, n_nodes * n_bins, C), dtype=vals.dtype,
                      device=vals.device)
    for f in range(F):
        acc = torch.zeros(((n_nodes + 1) * n_bins, C), dtype=vals.dtype,
                          device=vals.device)
        acc.index_add_(0, seg_node + binned[f].long(), vals)
        out[f] = acc[: n_nodes * n_bins]
    return out.reshape(F, n_nodes, n_bins, C).permute(1, 0, 2, 3) \
        .contiguous()


def histogram_batched_plain(binned: torch.Tensor, rel: torch.Tensor,
                            vals: torch.Tensor, n_nodes: int, n_bins: int
                            ) -> torch.Tensor:
    """[F, rows] codes + [K, rows] rel + [K, rows, C] vals ->
    [K, n_nodes, F, B, C]: tree k's live rows relabelled to nodes
    ``k·n_nodes + rel``, the K row streams concatenated, and
    ``histogram_plain`` over them with ``binned`` repeated K times."""
    K, rows = rel.shape
    if K == 1:
        return histogram_plain(binned, rel[0], vals[0], n_nodes,
                               n_bins)[None]
    off = (torch.arange(K, device=rel.device, dtype=rel.dtype)
           * n_nodes)[:, None]
    rel_f = torch.where(rel >= 0, rel + off, -1).reshape(K * rows)
    out = histogram_plain(binned.repeat(1, K), rel_f,
                          vals.reshape(K * rows, vals.shape[-1]),
                          K * n_nodes, n_bins)
    return out.reshape((K, n_nodes) + out.shape[1:])


def _node_bin_ranges(n_nodes: int, n_bins: int, C: int) -> tuple[int, int]:
    """(node·bin cells per range, number of ranges): the node·bin axis
    cut into ranges whose [cells, C] f32 histogram fits one block's
    shared memory."""
    range_segs = SHARED_HIST_BYTES // (4 * C)
    return range_segs, math.ceil(n_nodes * n_bins / range_segs)


def hist_mode(n_nodes: int, n_bins: int, C: int) -> str:
    """"shared" when one CTA holds the whole [n_nodes·B, C] histogram in
    shared memory (a single node·bin range), else "split"."""
    return "shared" if _node_bin_ranges(n_nodes, n_bins, C)[1] == 1 \
        else "split"


def _check(name, t, dtypes, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, binned on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def build_histogram_batched(binned: torch.Tensor, rel: torch.Tensor,
                            vals: torch.Tensor, n_nodes: int, n_bins: int
                            ) -> torch.Tensor:
    """[F, rows] codes, [K, rows] int32 rel, [K, rows, C] f32 vals (C in
    {2, 3}) -> [K, n_nodes, F, B, C] f32 sums of each tree's live rows;
    the binned matrix is read once for all K trees."""
    if binned.device.type == "cpu":
        return histogram_batched_plain(binned, rel, vals, n_nodes, n_bins)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if binned.dim() != 2:
        raise ValueError(f"binned must be [F, rows], got "
                         f"{tuple(binned.shape)}")
    F, rows = binned.shape
    if rel.dim() != 2:
        raise ValueError(f"rel must be [K, rows], got {tuple(rel.shape)}")
    K = rel.shape[0]
    if vals.dim() != 3 or vals.shape[2] not in (2, 3):
        raise ValueError(f"vals must be [K, rows, 2 or 3], got "
                         f"{tuple(vals.shape)}")
    C = vals.shape[2]
    if K < 1 or n_nodes < 1 or not 1 <= n_bins <= 32767 \
            or K * n_nodes * n_bins >= 2 ** 31:
        raise ValueError(f"bad K={K} / n_nodes={n_nodes} / "
                         f"n_bins={n_bins}")
    dev = binned.device
    _check("binned", binned, (torch.uint8, torch.int16), (F, rows), dev)
    _check("rel", rel, (torch.int32,), (K, rows), dev)
    _check("vals", vals, (torch.float32,), (K, rows, C), dev)
    lib = LIB.load()
    out = torch.zeros((K, n_nodes, F, n_bins, C), dtype=torch.float32,
                      device=dev)
    range_segs, n_ranges = _node_bin_ranges(K * n_nodes, n_bins, C)
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    row_blocks = max(1, min(math.ceil(_CTAS_PER_SM * _sm_count[dev.index]
                                      / (F * n_ranges)),
                            math.ceil(rows / _ROW_TILE), 65535))
    fn = lib.hist_launch_u8 if binned.dtype == torch.uint8 \
        else lib.hist_launch_i16
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(binned.data_ptr(), rel.data_ptr(), vals.data_ptr(),
             out.data_ptr(), K, n_nodes, F, n_bins, C, rows, range_segs,
             row_blocks, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error "
                           f"{err}")
    mode = hist_mode(K * n_nodes, n_bins, C)
    with _count_lock:
        LAUNCHES[mode] += 1
        if K > 1:
            BATCHED_LAUNCHES[mode] += 1
    return out


def build_histogram_kernel(binned: torch.Tensor, rel: torch.Tensor,
                           vals: torch.Tensor, n_nodes: int, n_bins: int
                           ) -> torch.Tensor:
    """[F, rows] codes, [rows] int32 rel, [rows, C] f32 vals (C in
    {2, 3}) -> [n_nodes, F, B, C] f32 sums over live rows: the K=1 call
    of ``build_histogram_batched``."""
    if binned.device.type == "cpu":
        return histogram_plain(binned, rel, vals, n_nodes, n_bins)
    if rel.dim() != 1 or vals.dim() != 2:
        raise ValueError(f"rel must be [rows] and vals [rows, C], got "
                         f"{tuple(rel.shape)} and {tuple(vals.shape)}")
    return build_histogram_batched(binned, rel[None], vals[None], n_nodes,
                                   n_bins)[0]


def build_histogram(binned: torch.Tensor, rel: torch.Tensor,
                    g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    n_nodes: int, n_bins: int, unit_hess: bool = False
                    ) -> torch.Tensor:
    """[n_nodes, F, B, 3] of (Σgw, Σhw, Σw) over live rows, or
    [..., 2] (Σgw, Σw) when ``unit_hess`` (the caller asserts h ≡ 1 and
    expands with ``expand_unit_hess``).

    binned: [F, rows] codes; rel: [rows] node id (-1 dead), or [K, rows]
    for K trees at once (then the result is [K, n_nodes, F, B, C]);
    g, h, w broadcast against rel (w: the row weight). A row is live
    when rel >= 0 and w > 0; ``where`` (not just ``*w``) keeps NaN
    gradients of dead rows out of the sums."""
    live = (rel >= 0) & (w > 0)
    rel = torch.where(live, rel, -1).to(torch.int32)
    chans = [g * w, w] if unit_hess else [g * w, h * w, w]
    chans = torch.broadcast_tensors(*chans, rel)[:-1]
    vals = torch.where(live[..., None], torch.stack(chans, dim=-1), 0.0)
    if rel.dim() == 1:
        return build_histogram_kernel(binned, rel, vals.contiguous(),
                                      n_nodes, n_bins)
    return build_histogram_batched(binned, rel.contiguous(),
                                   vals.contiguous(), n_nodes, n_bins)


def expand_unit_hess(hist2: torch.Tensor) -> torch.Tensor:
    """[..., 2] (Σgw, Σw) -> [..., 3] (Σgw, Σhw=Σw, Σw)."""
    return torch.cat([hist2[..., 0:1], hist2[..., 1:2], hist2[..., 1:2]],
                     dim=-1)
