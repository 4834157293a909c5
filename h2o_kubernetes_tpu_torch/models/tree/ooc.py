"""Out-of-core boosting: the binned matrix streamed from host memory in
row chunks (the JAX package's ``models/tree/ooc.py``).

When the uint8 binned matrix would not fit the device headroom that
``H2O_TPU_HIST_BYTES_BUDGET`` leaves (``models/gbm._ooc_chunk_rows``
decides), the matrix stays on the host as [F, chunk_rows] chunks and is
copied to the card once per tree level. Only the per-row columns (y, w
and the margin, chunked alongside) stay on the device, so the device
holds O(chunk·F + rows·12 B + level histograms).

The stream (``_stream``): the chunks sit in pinned host memory,
allocated once; two device staging buffers are allocated once per
train; chunk c+1 is copied into the free staging buffer on a side CUDA
stream, ``non_blocking``, while the histograms of chunk c run on the
compute stream. Events order the two: the compute stream waits for a
chunk's copy before it reads the buffer, and the copy into a buffer
waits for the compute stream to be done with the chunk it held before.
The copies' and the consumer's times are CUDA events (host clocks on
the CPU); ``boost_trees_chunked`` returns their sums: the upload time,
the histogram time, the passes' wall time and the overlap ratio (the
share of the upload time hidden under the histograms), kept on the
model as ``ooc_stats``. The same sums feed the telemetry registry
(``runtime/telemetry.ooc_stream_account``: the ``ooc_stream`` stat
group and the ``h2o_ooc_*`` series on ``GET /metrics``), and every
level's histogram and split find is a ``phase_span`` (the
``h2o_train_phase_seconds`` histogram and the ``diagnostics`` TimeLine;
host clock, not synchronized).

Numerics: each level's histograms are summed over the chunks in chunk
order with f32 adds, and every split and leaf goes through the shared
``core._find_splits`` / ``core._leaf_value``, so streamed and resident
chunks (``H2O_TPU_OOC_RESIDENT=1``) train bitwise the same, and the
chunked train equals the in-memory one bitwise where the sums are
exact (the first gaussian round on a ±0.5 response; integer counts)
and within f32 rounding elsewhere.

Scope (gated in ``models/gbm._ooc_chunk_rows``): pointwise
single-output boosting at sample_rate 1, no column sampling, no
mtries, no score_every, no checkpoint, no huber. GOSS streams too: its
selection is a function of exact global statistics and a per-row draw
keyed by the global row id, so the chunked path picks the rows the
in-memory path picks; per round one pass compacts each chunk's
selected rows into device buffers that every level of the tree then
reads, and one pass re-descends all rows for the margin. EFB streams
the bundled matrix (``efb.chunk_plan_host``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch

from ...ops.histogram import build_histogram, expand_unit_hess
from ...runtime import telemetry
from .core import (BoostParams, Tree, TreeParams, _boost_grad_hess,
                   _find_splits, _leaf_value, descend_level, descend_tree,
                   goss_cap_rows, goss_compact, goss_local_counts,
                   goss_rank_stat, goss_row_factor, goss_threshold)

__all__ = ["BinnedChunks", "chunk_rows_for", "make_chunks",
           "boost_trees_chunked"]


@dataclass
class BinnedChunks:
    """A row-chunked training set: binned [F, chunk_rows] uint8 chunks
    (pinned host tensors when streamed, device tensors when resident)
    and the matching device slices of y, w and the margin. Every chunk
    has one shape; the last is padded with dead rows (w = 0)."""

    binned: list
    y: list
    w: list
    margin: list
    chunk_rows: int
    padded_rows: int                # rows before chunking
    streamed: bool
    device: torch.device
    _staging: list = field(default_factory=list)
    _copy_stream: object = None
    _free: list = field(default_factory=list)
    # (start, end) pairs: uploads, consumer work, whole passes
    _marks: dict = field(default_factory=lambda: {
        "upload": [], "compute": [], "wall": []})
    upload_bytes: int = 0
    passes: int = 0

    @property
    def n_chunks(self) -> int:
        return len(self.binned)

    @property
    def n_features(self) -> int:
        return self.binned[0].shape[0]

    def stream_stats(self) -> dict:
        """Sums over every streamed pass so far: upload, consumer
        (histogram) and pass wall milliseconds, the bytes uploaded, and
        the overlap ratio 1 - max(wall - compute, 0) / upload — the
        share of the upload that did not lengthen the passes. CUDA
        event times on the card (this synchronizes), host clock
        times on the CPU."""
        if self.device.type == "cuda":
            from ..base import device_synchronize

            device_synchronize(self.device)
            ms = {k: sum(s.elapsed_time(e) for s, e in v)
                  for k, v in self._marks.items()}
        else:
            ms = {k: sum(e - s for s, e in v) * 1e3
                  for k, v in self._marks.items()}
        up = ms["upload"]
        hidden = 1.0 - max(ms["wall"] - ms["compute"], 0.0) / up \
            if up > 0 else 1.0
        return {"streamed": self.streamed, "chunks": self.n_chunks,
                "chunk_rows": self.chunk_rows, "passes": self.passes,
                "upload_ms": up, "compute_ms": ms["compute"],
                "wall_ms": ms["wall"], "upload_bytes": self.upload_bytes,
                "upload_gb_per_s": self.upload_bytes / up / 1e6
                if up > 0 else None,
                "overlap_ratio": min(max(hidden, 0.0), 1.0)}


def chunk_rows_for(padded_rows: int, n_features: int, budget: float,
                   hist_bytes: int) -> int:
    """Rows per chunk: a quarter of the histogram budget's headroom (two
    staging buffers, the copy in flight and slack) over the feature
    count, at least 1 MiB of codes, at most the table (the JAX
    package's rule on one row shard). ``H2O_TPU_OOC_CHUNK_ROWS``
    overrides."""
    env = os.environ.get("H2O_TPU_OOC_CHUNK_ROWS")
    if env:
        rows = int(env)
    else:
        headroom = max(budget - hist_bytes, 1 << 20)
        rows = int(max(headroom // 4, 1 << 20) // max(n_features, 1))
    return min(max(rows, 1), padded_rows)


def make_chunks(frame, bin_spec, y, w, margin, chunk_rows: int,
                plan=None) -> BinnedChunks:
    """The chunked training set of a frame: binned chunks from
    ``binning.bin_frame_host_chunks`` (one column on the device at a
    time), or from the EFB ``plan``'s bundled host matrix; y, w and the
    margin ([rows] on the frame's device) cut into device chunks, the
    tail padded with w = 0. Chunks are pinned when they will stream to
    a card; ``H2O_TPU_OOC_RESIDENT=1`` puts them on the device
    instead."""
    from .binning import bin_frame_host_chunks

    dev = y.device
    streamed = os.environ.get("H2O_TPU_OOC_RESIDENT", "0") != "1"
    pin = streamed and dev.type == "cuda"
    if plan is not None:
        from .efb import chunk_plan_host

        bufs = chunk_plan_host(plan, chunk_rows, pin_memory=pin)
    else:
        bufs = bin_frame_host_chunks(frame, bin_spec, chunk_rows,
                                     pin_memory=pin)
    if not streamed:
        bufs = [b.to(dev) for b in bufs]
    n = y.shape[0]
    total = len(bufs) * chunk_rows

    def cut(full):
        out = torch.zeros(total, dtype=torch.float32, device=dev)
        out[:n] = full
        return list(out.split(chunk_rows))

    return BinnedChunks(binned=bufs, y=cut(y), w=cut(w), margin=cut(margin),
                        chunk_rows=chunk_rows, padded_rows=n,
                        streamed=streamed, device=dev)


def _now(chunks: BinnedChunks, stream=None):
    """A time mark on ``stream`` (a recorded CUDA event), or the host
    clock on the CPU."""
    if chunks.device.type != "cuda":
        return time.perf_counter()
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


def _stream(chunks: BinnedChunks):
    """Yield each binned chunk on the device, in chunk order. Resident
    chunks pass through. Streamed ones are copied into two staging
    buffers in turn, the copy of chunk c+1 issued (on the side stream,
    non-blocking from pinned memory) before chunk c is handed out; each
    copy waits until the buffer's previous chunk is consumed."""
    if not chunks.streamed:
        yield from chunks.binned
        return
    cuda = chunks.device.type == "cuda"
    if not chunks._staging:
        chunks._staging = [torch.empty_like(chunks.binned[0],
                                            device=chunks.device)
                           for _ in range(min(2, chunks.n_chunks))]
        chunks._free = [None] * len(chunks._staging)
        if cuda:
            chunks._copy_stream = torch.cuda.Stream(chunks.device)
    compute = torch.cuda.current_stream(chunks.device) if cuda else None
    side = chunks._copy_stream
    marks = chunks._marks
    n_buf = len(chunks._staging)
    pass_start = _now(chunks, compute)
    ready = [None] * n_buf

    def upload(c):
        i = c % n_buf
        buf = chunks._staging[i]
        if cuda:
            with torch.cuda.stream(side):
                side.wait_event(chunks._free[i] or pass_start)
                s = _now(chunks, side)
                buf.copy_(chunks.binned[c], non_blocking=True)
                marks["upload"].append((s, _now(chunks, side)))
                ready[i] = torch.cuda.Event()
                ready[i].record(side)
        else:
            s = time.perf_counter()
            buf.copy_(chunks.binned[c])
            marks["upload"].append((s, time.perf_counter()))
        chunks.upload_bytes += chunks.binned[c].numel()

    upload(0)
    for c in range(chunks.n_chunks):
        i = c % n_buf
        if c + 1 < chunks.n_chunks:
            upload(c + 1)
        if cuda:
            compute.wait_event(ready[i])
        s = _now(chunks, compute)
        yield chunks._staging[i]
        marks["compute"].append((s, _now(chunks, compute)))
        if cuda:
            chunks._free[i] = torch.cuda.Event()
            chunks._free[i].record(compute)
    marks["wall"].append((pass_start, _now(chunks, compute)))
    chunks.passes += 1


def _hist(bc, rel, g, h, w, n_nodes, n_bins, p: TreeParams):
    return build_histogram(bc, rel, g, h, w, n_nodes, n_bins,
                           unit_hess=p.unit_hess)


def _descend(bc, rel, absn, split, d: int, n_bins: int, efb):
    """Move a chunk's rows from level d to d+1 through level d's splits:
    ``core.descend_level``, the in-memory grower's row walk, as T=1."""
    rel, absn = descend_level(bc, rel[None], absn[None],
                              tuple(a[None] for a in split), d, n_bins, efb)
    return rel[0], absn[0]


def _grow_tree_chunked(chunks: BinnedChunks, gs, hs, wts, p: TreeParams,
                       efb=None):
    """One tree over the chunk stream, level by level: per level one
    pass that descends each chunk's rows and adds its left-child
    histogram into the level's sum (chunk order, f32), then sibling
    subtraction and ``_find_splits`` on the sum. Returns (Tree [N] on
    the device, the last level's splits, per-chunk rel and abs nodes);
    the margin update is the caller's."""
    dev = chunks.device
    C = chunks.n_chunks
    N = 2 ** (p.max_depth + 1) - 1
    sf = torch.full((N,), -1, dtype=torch.int32, device=dev)
    sb = torch.zeros(N, dtype=torch.int32, device=dev)
    nl = torch.zeros(N, dtype=torch.bool, device=dev)
    isp = torch.zeros(N, dtype=torch.bool, device=dev)
    val = torch.zeros(N, dtype=torch.float32, device=dev)
    gn = torch.zeros(N, dtype=torch.float32, device=dev)
    cov = torch.zeros(N, dtype=torch.float32, device=dev)
    rel = [torch.zeros(chunks.chunk_rows, dtype=torch.int32, device=dev)
           for _ in range(C)]
    absn = [torch.zeros(chunks.chunk_rows, dtype=torch.int64, device=dev)
            for _ in range(C)]
    split = None
    for d in range(p.max_depth + 1):
        n_nodes = 2 ** d
        idx = slice(n_nodes - 1, 2 * n_nodes - 1)
        if d == p.max_depth:
            if d == 0:                     # a stump: one single-bin pass
                tot = None
                for ci, bc in enumerate(_stream(chunks)):
                    zb = torch.zeros((1, bc.shape[1]), dtype=torch.uint8,
                                     device=dev)
                    t = _hist(zb, rel[ci], gs[ci], hs[ci], wts[ci], 1, 1, p)
                    tot = t if tot is None else tot + t
                if p.unit_hess:
                    tot = expand_unit_hess(tot)
                tot = tot[:, 0, 0, :]
            else:
                tot = torch.where(can_prev[:, None, None],
                                  torch.stack([left_prev, right_prev], 1),
                                  0.0).reshape(n_nodes, 3)
            val[idx] = _leaf_value(tot[:, 0], tot[:, 1], p)
            cov[idx] = tot[:, 2]
            break
        acc = None
        with telemetry.phase_span("level_hist", depth=d):
            for ci, bc in enumerate(_stream(chunks)):
                if d == 0:
                    hc = _hist(bc, rel[ci], gs[ci], hs[ci], wts[ci], 1,
                               p.n_bins, p)
                else:
                    rel[ci], absn[ci] = _descend(bc, rel[ci], absn[ci],
                                                 split, d - 1, p.n_bins,
                                                 efb)
                    left_rel = torch.where(
                        (rel[ci] >= 0) & (rel[ci] % 2 == 0),
                        rel[ci] // 2, -1)
                    hc = _hist(bc, left_rel, gs[ci], hs[ci], wts[ci],
                               n_nodes // 2, p.n_bins, p)
                acc = hc if acc is None else acc + hc
        if p.unit_hess:
            acc = expand_unit_hess(acc)
        if d == 0:
            hist = acc
        else:
            keep = can_prev[:, None, None, None]
            hist_l = torch.where(keep, acc, 0.0)
            hist_r = torch.where(keep, hist_prev, 0.0) - hist_l
            hist = torch.stack([hist_l, hist_r], dim=1).reshape(
                (n_nodes,) + acc.shape[1:])
        with telemetry.phase_span("split_find", depth=d):
            (feat, bin_, na_l, can, v, g_best, c_, left_prev,
             right_prev) = _find_splits(hist, p, None, efb)
        sf[idx] = torch.where(can, feat, -1)
        sb[idx] = bin_
        nl[idx] = na_l
        isp[idx] = can
        val[idx] = v
        gn[idx] = torch.where(can, g_best, 0.0)
        cov[idx] = c_
        hist_prev, can_prev = hist, can
        split = (feat, bin_, na_l, can)
    return Tree(sf, sb, nl, isp, val, gn, cov), split, rel, absn


def _goss_round_chunked(chunks: BinnedChunks, gs, hs, wts, kg,
                        cap_local: int, p: TreeParams, bp: BoostParams,
                        efb=None):
    """One GOSS round over the stream: the global max |g| and count
    histogram combined over chunks on the device (max and int32 adds,
    exact in any order), one pass that compacts each chunk's selected
    rows (row ids ``ci·chunk_rows + arange``) into device buffers, the
    tree grown over those buffers, and one pass that re-descends every
    row for the margin. Returns (the learn-rate-scaled Tree, the rows
    dropped past the buffers as a device scalar)."""
    m = None
    for ci in range(chunks.n_chunks):
        mc = torch.max(goss_rank_stat(gs[ci], wts[ci]))
        m = mc if m is None else torch.maximum(m, mc)
    counts = total = None
    for ci in range(chunks.n_chunks):
        cc, nc = goss_local_counts(goss_rank_stat(gs[ci], wts[ci]),
                                   wts[ci] > 0, m)
        counts = cc if counts is None else counts + cc
        total = nc if total is None else total + nc
    T, frac = goss_threshold(counts, total, bp.goss_a)
    bufs, gC, hC, wC, dropped = [], [], [], [], None
    for ci, bc in enumerate(_stream(chunks)):
        w = wts[ci]
        row_ids = ci * chunks.chunk_rows + torch.arange(
            chunks.chunk_rows, dtype=torch.int32, device=w.device)
        factor = goss_row_factor(goss_rank_stat(gs[ci], w), w > 0, m, T,
                                 frac, kg, row_ids, bp.goss_a, bp.goss_b)
        b_, g_, h_, w_, dc = goss_compact(bc, gs[ci], hs[ci], w * factor,
                                          cap_local)
        bufs.append(b_)
        gC.append(g_)
        hC.append(h_)
        wC.append(w_)
        dropped = dc if dropped is None else dropped + dc
    comp = BinnedChunks(binned=bufs, y=[], w=[], margin=[],
                        chunk_rows=cap_local,
                        padded_rows=chunks.padded_rows, streamed=False,
                        device=chunks.device)
    tree = _grow_tree_chunked(comp, gC, hC, wC, p, efb)[0]
    tree = tree._replace(value=bp.learn_rate * tree.value)
    for ci, bc in enumerate(_stream(chunks)):
        chunks.margin[ci] = chunks.margin[ci] + tree.value[descend_tree(
            tree, bc, p.max_depth, p.n_bins, efb)]
    return tree, dropped


def boost_trees_chunked(chunks: BinnedChunks, n_trees: int, p: TreeParams,
                        bp: BoostParams, efb=None, goss_keys=None):
    """``n_trees`` boosting rounds over the chunk stream. Per round the
    chunks' gradients, the tree grown level by level over the stream
    (or a GOSS round), and the margin update in one more pass (the
    final level's descent). Returns (margin [rows] on the device, trees
    stacked [T, N], the GOSS rows dropped or None, the stream's
    ``stream_stats``, also fed to ``telemetry.ooc_stream_account``)."""
    if bp.drf_mode or bp.sample_rate < 1.0 or \
            bp.col_sample_rate_per_tree < 1.0 or p.mtries > 0:
        raise ValueError("out-of-core boosting takes pointwise boosting "
                         "without row, column or mtries sampling "
                         "(models/gbm._ooc_chunk_rows gates the rest)")
    goss = bp.goss_b > 0.0
    cap_local = goss_cap_rows(chunks.chunk_rows, bp.goss_a, bp.goss_b)
    trees, dropped = [], None
    for t in range(n_trees):
        gs, hs = [], []
        for ci in range(chunks.n_chunks):
            g, h = _boost_grad_hess(bp, chunks.margin[ci], chunks.y[ci],
                                    chunks.w[ci])
            gs.append(g)
            hs.append(h)
        if goss:
            tree, dc = _goss_round_chunked(chunks, gs, hs, chunks.w,
                                           goss_keys[t], cap_local, p, bp,
                                           efb)
            dropped = dc if dropped is None else dropped + dc
            trees.append(tree)
            continue
        tree, split, rel, absn = _grow_tree_chunked(chunks, gs, hs,
                                                    chunks.w, p, efb)
        tree = tree._replace(value=bp.learn_rate * tree.value)
        if p.max_depth > 0:
            for ci, bc in enumerate(_stream(chunks)):
                _, a = _descend(bc, rel[ci], absn[ci], split,
                                p.max_depth - 1, p.n_bins, efb)
                chunks.margin[ci] = chunks.margin[ci] + tree.value[a]
        else:
            for ci in range(chunks.n_chunks):
                chunks.margin[ci] = chunks.margin[ci] + tree.value[0]
        trees.append(tree)
    margin = torch.cat(chunks.margin)[: chunks.padded_rows]
    stacked = Tree(*(torch.stack(a) for a in zip(*trees)))
    stats = chunks.stream_stats()
    telemetry.ooc_stream_account(stats["upload_ms"] / 1e3,
                                 stats["compute_ms"] / 1e3,
                                 stats["wall_ms"] / 1e3)
    return margin, stacked, dropped, stats
