"""PyTorch port, the histogram kernel's launch plan (``hist_plan``) and
the row partition's plain version (plain Python; no JAX and no card
here).

At every level shape of the port's four trains — bench.py's GBM at depth
5 and at depth 10 (its AUC's 4096 int16 bins too), drf_higgs's forest
and gbm_multinomial — and at the edge shapes the card-only tests use
(node ranges, bin chunks, odd row counts, more features than one group
holds), the plan must cover every (tree·node, feature, bin) cell exactly
once per row block and ask no CTA for more than the 232,448 bytes of
shared memory a block can opt into, in either regime family (streaming
and partitioned). The partition's plain version must equal a numpy
stable sort of the live (tree, row) pairs by tree·node.
"""

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch.ops import histogram as H


def _train_levels():
    """(K, n_nodes, F, n_bins, C, rows, code bytes) of each histogrammed
    level: left children only after the root, so level d has
    max(1, 2**(d-1)) nodes per tree."""
    out = []
    for d in range(10):                     # GBM depth 5 and depth 10
        for C in (2, 3):
            out.append((1, max(1, 2 ** (d - 1)), 10, 256, C, 1_000_000, 1))
    out.append((1, 1, 1, 4096, 3, 1_000_000, 2))          # the AUC
    out.append((1, 1, 1, 4096, 3, 70_001, 2))
    out += [(10, max(1, 2 ** (d - 1)), 28, 64, 2, 1_000_000, 1)
            for d in range(8)]                            # drf_higgs
    out += [(4, max(1, 2 ** (d - 1)), 10, 256, 3, 500_000, 1)
            for d in range(5)]                            # gbm_multinomial
    return out


_EDGES = [(1, 1024, 2, 256, 3, 60_000, 1), (1, 2, 2, 20_000, 3, 50_000, 2),
          (1, 4, 28, 64, 2, 100_003, 1), (1, 1, 40, 256, 3, 50_000, 1),
          (10, 64, 6, 64, 2, 50_001, 1), (3, 7, 33, 100, 2, 9, 1),
          (1, 1, 1, 32_767, 2, 1_000, 2)]
_CASES = _train_levels() + _EDGES


def _coverage(p):
    """How many CTAs of one row block own each (tree·node, feature,
    bin) cell."""
    count = np.zeros((p.K * p.n_nodes, p.F, p.n_bins), dtype=np.int32)
    for z in range(p.ranges * p.bin_chunks):
        for g in range(p.groups):
            nodes, feats, bins = p.cta_cells(g, z)
            count[nodes.start:nodes.stop, feats.start:feats.stop,
                  bins.start:bins.stop] += 1
    return count


def _check(p, rows, cb):
    assert (_coverage(p) == 1).all()
    assert p.smem_bytes <= H.BLOCK_SMEM
    assert p.group <= (32 if p.regime == "partitioned" and cb == 1 else
                       16 if p.regime == "partitioned" else 8)
    assert 1 <= p.row_blocks <= 65535
    if p.regime == "partitioned":
        assert p.smem_bytes == 4 * p.node_range * p.group * p.n_bins * p.C \
            + 4 * (p.node_range + 1)
        assert p.bin_chunks == 1 and p.replicas == 1
        assert p.groups == 1 or p.group * cb % 16 == 0
        assert p.stride % 16 == 0 and p.stride >= p.F * cb
        assert p.part_tile % 32 == 0 and 256 <= p.part_tile <= 4096
        assert p.part_tiles * p.K * p.n_nodes <= (1 << 22) \
            or p.part_tile == 4096
        assert (p.part_tiles - 1) * p.part_tile < p.K * rows \
            <= p.part_tiles * p.part_tile
        assert p.part_warps * 4 * p.K * p.n_nodes <= H.BLOCK_SMEM
    else:
        assert p.smem_bytes == 4 * p.replicas * p.node_range * p.group \
            * p.bin_chunk * p.C
        assert p.rows_per_thread == (4 if rows % 4 == 0 else 1)
        assert p.regime == ("replicated" if p.replicas > 1 else "grouped")


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "K{}n{}F{}B{}C{}r{}"
                         .format(*c[:6]))
def test_plan_covers_each_cell_once_within_the_card(case):
    K, n, F, B, C, rows, cb = case
    p = H.hist_plan(K, n, F, B, C, rows, cb)
    _check(p, rows, cb)
    assert p.regime == H.hist_mode(K, n, F, B, C, cb, rows)
    if 4 * B * C <= H.BLOCK_SMEM:          # one node fits a tile
        alt = H.hist_plan(K, n, F, B, C, rows, cb,
                          partition=p.regime != "partitioned")
        _check(alt, rows, cb)
    else:
        with pytest.raises(ValueError):
            H.hist_plan(K, n, F, B, C, rows, cb, partition=True)


def test_the_main_levels_read_the_rows_once_or_few_times():
    """The roots are streamed in a few feature groups; the deep levels of
    the forest and of the depth-10 GBM, where one streaming CTA would
    fill an SM (320+ tree·nodes of the forest, 64+ nodes of the GBM),
    are partitioned, and read each sorted pair once; the levels just
    above them and the multinomial's levels are streamed."""
    for K, F, B, C, rows in ((10, 28, 64, 2, 1_000_000),
                             (4, 10, 256, 3, 500_000),
                             (1, 10, 256, 3, 1_000_000)):
        p = H.hist_plan(K, 1, F, B, C, rows)
        assert p.regime != "partitioned" and p.passes <= 4
    for K, n, F, B, C in ((10, 64, 28, 64, 2), (10, 32, 28, 64, 2),
                          (1, 256, 10, 256, 3), (1, 64, 10, 256, 3)):
        p = H.hist_plan(K, n, F, B, C, 1_000_000)
        assert p.regime == "partitioned" and p.passes == 1
    for K, n, F, B, C in ((10, 16, 28, 64, 2), (10, 8, 28, 64, 2),
                          (1, 32, 10, 256, 3)):
        assert H.hist_plan(K, n, F, B, C, 1_000_000).regime \
            != "partitioned"
    for d in range(5):
        assert H.hist_mode(4, max(1, 2 ** (d - 1)), 10, 256, 3,
                           rows=500_000) != "partitioned"


@pytest.mark.parametrize("K,rows,F,n,code", [
    (10, 5000, 28, 64, np.uint8), (1, 3001, 10, 256, np.uint8),
    (4, 777, 3, 8, np.int16), (3, 10, 33, 2, np.uint8)])
def test_row_partition_plain_is_a_stable_sort_by_tree_node(K, rows, F, n,
                                                           code):
    rng = np.random.default_rng(rows)
    binned = rng.integers(0, 200, size=(F, rows)).astype(code)
    rel = rng.integers(-1, n + 1, size=(K, rows)).astype(np.int32)
    vals = rng.normal(size=(K, rows, 3)).astype(np.float32)
    stride = 16 * -(-F * binned.itemsize // 16)
    seg, codes, vs = H.row_partition(
        torch.as_tensor(binned), torch.as_tensor(rel), torch.as_tensor(vals),
        n, stride)
    live = (rel >= 0) & (rel < n)
    key = np.where(live, rel + np.arange(K)[:, None] * n, K * n).ravel()
    order = np.argsort(key, kind="stable")[: live.sum()]
    want_codes = np.zeros((order.size, stride), np.uint8)
    rowmajor = np.ascontiguousarray(binned.T).view(np.uint8)
    want_codes[:, : rowmajor.shape[1]] = rowmajor[order % rows]
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(vs.numpy(), vals.reshape(K * rows, 3)[
        order])
    np.testing.assert_array_equal(seg.numpy(), np.searchsorted(
        key[order], np.arange(K * n + 1)))
