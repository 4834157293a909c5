"""The per-level histogram build of the tree learners — their hot op.

Per tree level every live row adds (g·w, h·w, w) — or (g·w, w) under a
unit hessian — into cell [node, feature, bin] of ``hist[n_nodes, F, B,
C]``. Forests and multinomial models grow K trees per step against one
binned matrix, so the build is batched over trees:
``build_histogram_batched(binned, rel [K, rows], vals [K, rows, C],
n_nodes, n_bins) -> [K, n_nodes, F, B, C]``. The single-tree
``build_histogram_kernel`` is its K=1 call. Both dispatch on the
tensors' device:

- CPU tensors take the plain torch version (``histogram_plain``: one
  ``index_add_`` per feature over ``rel·B + bin``, dead rows sent to a
  junk segment — the JAX package's ``_hist_segment``; batched, tree k's
  live rows are relabelled to nodes ``k·n_nodes + rel`` and the K row
  streams are concatenated against the binned matrix repeated K times,
  the JAX package's vmap rule);
- CUDA tensors launch the hand-written kernels in ``csrc/histogram.cu``,
  or raise. There is no fallback and no switch.

The kernels replace three TPU kernels of the JAX package's
``ops/histogram.py``: B1 ``_hist_fact_kernel`` (:141, shallow levels),
B2 ``_hist_kernel`` (:300, levels with ``n·B > 32768``) and B3
``_hist_vmappable`` (:399, K trees per launch). On an H100 a level is
bound by bytes — codes, rel and vals read once, the output written once,
tens of µs at 3.35 TB/s — but the time goes to the F·C shared-memory
adds per live (tree, row) (an f32 shared atomic is a compare-and-swap
loop on sm_90), to re-reading the (tree, row) stream when a level's
histogram does not fit one CTA, and to flushing partial histograms with
global atomics. ``hist_plan`` (plain Python, tested on the CPU) picks
the launch by shape, in one of three regimes:

- ``grouped``: a CTA holds a group of G features' whole [K·n, B, C]
  histograms in shared memory and reads each (tree, row) once for all G
  (every feature at the roots);
- ``replicated``: the same, where one group holds every feature and
  shared memory is spare: R copies, warp w adding into copy w % R, which
  splits the contention of the shallow levels;
- ``partitioned``: where a streaming CTA would hold one SM's shared
  memory alone (the deep levels, whose histograms of one feature exceed
  half an SM's), ``row_partition`` first sorts the level's live pairs
  by tree·node, stably, with each pair's codes and vals beside it; then
  a CTA owns a tile of tree·nodes × a group of features and reads only
  its tile's pairs.

Row blocks (or splits of a tile) are sized to the CTAs that fit on the
card; streaming row blocks stay few enough that the flush's global
atomics (one per row block and output cell) stay bounded.

``binned`` is FEATURE-MAJOR [F, rows]: uint8 bin codes for training,
int16 for the 4096-bin AUC histogram.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass

import torch

from ._build import KernelLib

__all__ = ["build_histogram", "build_histogram_kernel",
           "build_histogram_batched", "histogram_plain",
           "histogram_batched_plain", "expand_unit_hess", "hist_mode",
           "hist_plan", "HistPlan", "row_partition", "row_partition_plain",
           "build", "LIB", "LAUNCHES", "BATCHED_LAUNCHES",
           "PARTITION_LAUNCHES", "REGIMES", "BLOCK_SMEM", "reset_launches"]

# Hopper: shared memory one block can opt into, and one SM's (each
# resident block also takes 1 KB of the SM's for the runtime)
BLOCK_SMEM = 232_448
_SM_SMEM = 233_472
_BLOCK_RESERVED = 1024
_THREADS = 512              # per CTA (csrc/histogram.cu kThreads)
_THREADS_PER_SM = 2048
_REGS_PER_SM = 65536
# features per group the kernels hold in registers (csrc/histogram.cu):
# hist_seg by code bytes (kMaxGroup), hist_stream (kStreamGroup)
_MAX_GROUP = {1: 32, 2: 16}
_STREAM_GROUP = 8
_MAX_REPLICAS = 2
# CTAs per SM the shared-memory shares aim for: hist_stream's and
# hist_seg's __launch_bounds__ minimum (their registers allow three)
_TARGET_CTAS = 3
_WAVES = 4                  # streaming grids fill the resident CTAs this often
_SEG_WAVES = 8              # partitioned ones: the trains' tiles are uneven
# a CTA adds at least this many times more rows into a cell than the one
# partial it flushes into the output: row blocks <= rows / (4·n·B)
_FLUSH_SHARE = 4
_PART_TILE = 4096           # (tree, row) pairs per partition warp, at most
_PART_WARPS_PER_SM = 16     # partition warps the tiles aim to put on an SM
_PART_COUNTS = 1 << 22      # per-tile counts (tree·nodes x tiles), at most
_PART_WARPS = 8             # partition warps per CTA, at most
REGIMES = ("grouped", "replicated", "partitioned")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = KernelLib("histogram", {
    "hist_launch": [_P, _I, _P, _P, _P] + [_I] * 5 + [ctypes.c_longlong]
    + [_I] * 7 + [_P],
    "part_launch": [_P, _I] + [_P] * 6 + [_I] * 4 + [ctypes.c_longlong]
    + [_I] * 5 + [_P],
    "seg_hist_launch": [_P, _I, _P, _P, _P] + [_I] * 9 + [_P],
    "hist_regs": [_I] * 4})
build = LIB.build
_count_lock = threading.Lock()
# histogram launches by regime; module globals, so a caller that wraps
# build_histogram_kernel still reads and resets the wrapper's own count.
# BATCHED_LAUNCHES counts the launches over K > 1 trees (B3), which are
# also in LAUNCHES; PARTITION_LAUNCHES the row partitions (each a count
# and a scatter kernel) that the partitioned regime runs first.
LAUNCHES = dict.fromkeys(REGIMES, 0)
BATCHED_LAUNCHES = dict.fromkeys(REGIMES, 0)
PARTITION_LAUNCHES = {"row_partition": 0}
_sm_count: dict[int, int] = {}
_regs_cache: dict[tuple, int] = {}
_plans: dict[tuple, "HistPlan"] = {}


def reset_launches() -> None:
    """Set every launch count to 0."""
    with _count_lock:
        LAUNCHES.update(dict.fromkeys(REGIMES, 0))
        BATCHED_LAUNCHES.update(dict.fromkeys(REGIMES, 0))
        PARTITION_LAUNCHES["row_partition"] = 0


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


@dataclass(frozen=True)
class HistPlan:
    """The launch of one [K, n_nodes, F, B, C] level.

    Streaming regimes: grid (row_blocks, groups, ranges·bin_chunks); CTA
    (x, g, z) holds the cells of tree·nodes ``[z // bin_chunks ·
    node_range, +node_range)``, features ``[g·group, +group)`` and bins
    ``[z % bin_chunks · bin_chunk, +bin_chunk)``, with ``replicas``
    copies, over every ``row_blocks``-th quad of ``rows_per_thread`` rows.
    Partitioned: the same cells with ``node_range`` the tree·nodes of a
    tile (one bin chunk, one copy), ``row_blocks`` CTAs splitting each
    tile's sorted pairs; the partition runs ``part_tiles`` warps of
    ``part_tile`` pairs, ``part_warps`` per CTA, and keeps each pair's
    codes in ``stride`` bytes."""
    K: int
    n_nodes: int
    F: int
    n_bins: int
    C: int
    regime: str
    rows_per_thread: int
    group: int
    groups: int
    node_range: int
    ranges: int
    bin_chunk: int
    bin_chunks: int
    replicas: int
    row_blocks: int
    smem_bytes: int
    part_tile: int = 0
    part_tiles: int = 0
    part_warps: int = 0
    stride: int = 0

    @property
    def passes(self) -> int:
        """Reads of the (tree, row) stream by the histogram kernel: one
        per feature group, node range and bin chunk (partitioned: one per
        feature group, each tile reading only its pairs)."""
        if self.regime == "partitioned":
            return self.groups
        return self.groups * self.ranges * self.bin_chunks

    def cta_cells(self, group: int, z: int) -> tuple[range, range, range]:
        """(tree·nodes, features, bins) whose cells the CTAs at grid
        (·, group, z) own — the kernels' mapping."""
        lo = z // self.bin_chunks * self.node_range
        b0 = z % self.bin_chunks * self.bin_chunk
        return (range(lo, min(lo + self.node_range, self.K * self.n_nodes)),
                range(group * self.group,
                      min((group + 1) * self.group, self.F)),
                range(b0, min(b0 + self.bin_chunk, self.n_bins)))


def _per_sm(regs: int, smem: int) -> int:
    """CTAs of ``_THREADS`` threads that fit one SM."""
    return max(1, min(_THREADS_PER_SM // _THREADS,
                      _REGS_PER_SM // (regs * _THREADS),
                      _SM_SMEM // (smem + _BLOCK_RESERVED)))


def hist_plan(K: int, n_nodes: int, F: int, n_bins: int, C: int,
              rows: int = 0, code_bytes: int = 1, sm_count: int = 132,
              aligned: bool = True, regs: tuple = (40, 40),
              partition: bool | None = None) -> HistPlan:
    """The launch for a level of K trees × n_nodes × F features × n_bins
    × C channels over ``rows`` rows, on a card of ``sm_count`` SMs whose
    streaming and partitioned kernels take ``regs`` registers per thread.

    Streaming: a group holds as many features (up to ``_STREAM_GROUP``)
    as fit next to the level's K·n_nodes tree·nodes in a
    ``_TARGET_CTAS``-th of an SM's shared memory — more warps to hide the
    atomics measured faster than fewer passes — and at least one (node
    ranges and bin chunks only where one feature does not fit a CTA); up
    to ``_MAX_REPLICAS`` replicas take the spare of that share. A level
    of several nodes whose streaming CTA would hold one SM's shared
    memory alone (one CTA per SM) is partitioned instead, where it can
    be: a tile holds as many tree·nodes of a feature group as fit a
    ``_TARGET_CTAS``-th of an SM, and the partition's warps take tiles of
    pairs small enough to put ``_PART_WARPS_PER_SM`` warps on each SM,
    but large enough to keep the per-tile counts under ``_PART_COUNTS``.
    Streaming row blocks fill the card's resident CTAs ``_WAVES`` times,
    but past one wave stay few enough that a CTA adds ``_FLUSH_SHARE``
    times more rows into a cell (on average) than the one partial it
    flushes into the output; tile splits fill them ``_SEG_WAVES`` times.
    ``partition`` pins the regime family (for measuring the other
    one)."""
    kn = K * n_nodes
    bin_chunk = min(n_bins, BLOCK_SMEM // (4 * C))
    bin_chunks = math.ceil(n_bins / bin_chunk)
    node_bytes = 4 * C * bin_chunk          # one tree·node of one feature
    node_range = min(kn, BLOCK_SMEM // node_bytes)
    ranges = math.ceil(kn / node_range)
    share = min(BLOCK_SMEM, _SM_SMEM // _TARGET_CTAS - _BLOCK_RESERVED)
    G = min(F, _STREAM_GROUP, max(1, share // (node_range * node_bytes)))
    groups = math.ceil(F / G)
    G = math.ceil(F / groups)
    passes = groups * ranges * bin_chunks
    slab = node_range * G * node_bytes      # one streaming copy
    cell = 4 * C * n_bins
    # partitioned: groups aligned to 16 bytes of codes when there are
    # several; the partition's per-warp counts must fit shared memory
    pG = min(F, _MAX_GROUP[code_bytes], (BLOCK_SMEM - 8) // (cell + 4))
    if pG < F:
        pG -= pG % (16 // code_bytes)
    can_partition = pG >= 1 and kn * 4 <= BLOCK_SMEM and cell <= BLOCK_SMEM \
        and K * rows < 2 ** 31
    if partition is None:
        # at the trains' levels streaming won wherever two of its CTAs
        # fit an SM, the partitioned tiles wherever one did
        # (tools/torch_hist_sweep.py --train --plans, H100)
        partition = can_partition and n_nodes > 1 \
            and _SM_SMEM // (slab + _BLOCK_RESERVED) < 2
    if partition:
        if not can_partition:
            raise ValueError(f"level {K}x{n_nodes}x{F}x{n_bins}x{C} over "
                             f"{rows} rows cannot be partitioned")
        pgroups = math.ceil(F / pG)
        tile = max(1, min(kn, (share - 4) // (pG * cell + 4)))
        tiles = math.ceil(kn / tile)
        smem = tile * pG * cell + 4 * (tile + 1)
        # no flush cap: the trees' nodes are uneven, and a split that
        # found few pairs flushes only the cells it touched
        splits = max(1, min(_SEG_WAVES * sm_count * _per_sm(regs[1], smem)
                            // (pgroups * tiles), 65535))
        part_tile = 32 * min(_PART_TILE // 32, max(
            8, math.ceil(K * rows / (sm_count * _PART_WARPS_PER_SM * 32)),
            math.ceil(K * rows * kn / (_PART_COUNTS * 32))))
        return HistPlan(
            K=K, n_nodes=n_nodes, F=F, n_bins=n_bins, C=C,
            regime="partitioned", rows_per_thread=1, group=pG,
            groups=pgroups, node_range=tile, ranges=tiles, bin_chunk=n_bins,
            bin_chunks=1, replicas=1, row_blocks=splits,
            smem_bytes=smem, part_tile=part_tile,
            part_tiles=max(1, math.ceil(K * rows / part_tile)),
            part_warps=max(1, min(_PART_WARPS, BLOCK_SMEM // (4 * kn))),
            stride=16 * math.ceil(F * code_bytes / 16))
    R = max(1, min(_MAX_REPLICAS, share // slab))
    smem = R * slab
    wave = sm_count * _per_sm(regs[0], smem) // passes
    flush_cap = max(wave, rows // (_FLUSH_SHARE * n_nodes * n_bins))
    row_blocks = max(1, min(_WAVES * wave, flush_cap, 65535))
    return HistPlan(K=K, n_nodes=n_nodes, F=F, n_bins=n_bins, C=C,
                    regime="replicated" if R > 1 else "grouped",
                    rows_per_thread=4 if aligned and rows % 4 == 0 else 1,
                    group=G, groups=groups, node_range=node_range,
                    ranges=ranges, bin_chunk=bin_chunk,
                    bin_chunks=bin_chunks, replicas=R,
                    row_blocks=row_blocks, smem_bytes=smem)


def hist_mode(K: int, n_nodes: int, F: int, n_bins: int, C: int,
              code_bytes: int = 1, rows: int = 1 << 20) -> str:
    """The regime ``hist_plan`` picks for a level of ``rows`` rows."""
    return hist_plan(K, n_nodes, F, n_bins, C, rows, code_bytes).regime


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


def _check_level(binned, rel, vals, n_nodes, n_bins):
    """Check a level's tensors (as the kernels take them) -> (K, F, rows,
    C)."""
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
    return K, F, rows, C


def row_partition_plain(binned: torch.Tensor, rel: torch.Tensor,
                        vals: torch.Tensor, n_nodes: int, stride: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The live (tree, row) pairs p = k·rows + r of a level, stably
    sorted by tree·node k·n_nodes + rel[k, r] -> (seg [K·n_nodes + 1]
    int32 segment starts, codes [live, stride] uint8: each pair's row of
    F codes little-endian and zero-padded, vals [live, C])."""
    K, rows = rel.shape
    kn = K * n_nodes
    live = (rel >= 0) & (rel < n_nodes)
    key = torch.where(live, rel.long() + torch.arange(
        K, device=rel.device)[:, None] * n_nodes, kn).reshape(-1)
    order = torch.sort(key, stable=True).indices[: int(live.sum())]
    counts = torch.bincount(key[order], minlength=kn)
    seg = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    rowmajor = binned.T.contiguous().view(torch.uint8)   # [rows, F·bytes]
    codes = torch.zeros((order.numel(), stride), dtype=torch.uint8,
                        device=rel.device)
    codes[:, : rowmajor.shape[1]] = rowmajor[order % rows]
    return seg, codes, vals.reshape(K * rows, -1)[order]


def row_partition(binned: torch.Tensor, rel: torch.Tensor,
                  vals: torch.Tensor, n_nodes: int, stride: int,
                  plan: HistPlan | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``row_partition_plain``'s contract; on a CUDA card the count and
    scatter kernels of ``csrc/histogram.cu`` (one launch counted), whose
    codes and vals have room for all K·rows pairs (rows past seg[-1] are
    unset). ``plan`` gives the partition's tiles and warps."""
    if binned.device.type == "cpu":
        return row_partition_plain(binned, rel, vals, n_nodes, stride)
    K, F, rows, C = _check_level(binned, rel, vals, n_nodes, 1)
    if plan is None:
        plan = hist_plan(K, n_nodes, F, 1, C, rows, binned.element_size(),
                         partition=True)
    kn = K * n_nodes
    dev = binned.device
    lib = LIB.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cnt = torch.empty(kn * plan.part_tiles, dtype=torch.int32, device=dev)
    codes = torch.empty((K * rows, stride), dtype=torch.uint8, device=dev)
    vals_s = torch.empty((K * rows, C), dtype=torch.float32, device=dev)
    args = (binned.data_ptr(), binned.element_size(), rel.data_ptr(),
            vals.data_ptr(), cnt.data_ptr())
    tail = (codes.data_ptr(), vals_s.data_ptr(), K, n_nodes, F, C, rows,
            plan.part_tile, plan.part_tiles, plan.part_warps, stride,
            dev.index, stream)
    err = lib.part_launch(*args, None, *tail)
    if err == 0:
        excl = cnt.cumsum(0, dtype=torch.int32) - cnt
        seg = torch.cat([excl.view(kn, plan.part_tiles)[:, 0],
                         (excl[-1:] + cnt[-1:])])
        err = lib.part_launch(*args, excl.data_ptr(), *tail)
    if err != 0:
        raise RuntimeError(f"row partition launch failed: CUDA error {err}"
                           f" ({plan})")
    with _count_lock:
        PARTITION_LAUNCHES["row_partition"] += 1
    return seg, codes, vals_s


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
    K, F, rows, C = _check_level(binned, rel, vals, n_nodes, n_bins)
    out = torch.zeros((K, n_nodes, F, n_bins, C), dtype=torch.float32,
                      device=binned.device)
    if F == 0:
        return out
    _launch(binned, rel, vals, out, _card_plan(binned, rel, vals, n_nodes,
                                               n_bins))
    return out


def _card_plan(binned, rel, vals, n_nodes, n_bins, **pin) -> HistPlan:
    """``hist_plan`` for checked CUDA tensors on their card: its SM
    count, the tensors' alignment and the registers of the kernel
    instances (which decide how many CTAs fit an SM); cached, since the
    trains ask for the same levels again and again. ``pin`` passes
    ``partition`` through."""
    dev = binned.device
    key = (rel.shape[0], n_nodes, binned.shape[0], n_bins, vals.shape[2],
           binned.shape[1], binned.element_size(), dev.index,
           all(t.data_ptr() % 16 == 0 for t in (binned, rel, vals)),
           tuple(sorted(pin.items())))
    plan = _plans.get(key)
    if plan is None:
        if dev.index not in _sm_count:
            _sm_count[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        args = key[:7] + (_sm_count[dev.index], key[8])
        rpt = hist_plan(*args).rows_per_thread
        regs = tuple(_regs(kind, key[6], rpt, key[4]) for kind in range(2))
        if len(_plans) > 4096:
            _plans.clear()
        plan = _plans[key] = hist_plan(*args, regs, **pin)
    return plan


def _regs(kind: int, code_bytes: int, rpt: int, C: int) -> int:
    """Registers per thread of a histogram kernel instance: the
    streaming (kind 0) or the partitioned (1) one."""
    key = (kind, code_bytes, rpt, C)
    if key not in _regs_cache:
        n = LIB.load().hist_regs(*key)
        if n <= 0:
            raise RuntimeError(f"histogram kernel {key} not found")
        _regs_cache[key] = n
    return _regs_cache[key]


def _launch(binned, rel, vals, out, plan: HistPlan) -> None:
    """Launch the kernels of ``plan`` on checked tensors (``out``
    zeroed) and count the launch; raise if a launch is refused."""
    lib = LIB.load()
    dev = binned.device
    cb = binned.element_size()
    if plan.regime == "partitioned":
        seg, codes, vals_s = row_partition(binned, rel, vals, plan.n_nodes,
                                           plan.stride, plan)
        err = lib.seg_hist_launch(
            codes.data_ptr(), cb, vals_s.data_ptr(), seg.data_ptr(),
            out.data_ptr(), plan.K * plan.n_nodes, plan.F, plan.n_bins,
            plan.C, plan.stride, plan.group, plan.node_range,
            plan.row_blocks, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    else:
        err = lib.hist_launch(
            binned.data_ptr(), cb, rel.data_ptr(), vals.data_ptr(),
            out.data_ptr(), plan.K, plan.n_nodes, plan.F, plan.n_bins,
            plan.C, binned.shape[1], plan.rows_per_thread, plan.group,
            plan.node_range, plan.bin_chunk, plan.replicas, plan.row_blocks,
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error "
                           f"{err} ({plan})")
    with _count_lock:
        LAUNCHES[plan.regime] += 1
        if plan.K > 1:
            BATCHED_LAUNCHES[plan.regime] += 1


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
