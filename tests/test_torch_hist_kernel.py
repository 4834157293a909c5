"""PyTorch port, the histogram kernel wrapper on its own (no JAX here,
so the card-only cases also run where the JAX package is absent).

On the CPU the wrapper is its plain version, checked here against a
float64 numpy scatter. On a CUDA card (``-m cuda``) the kernel must
agree with the plain version within 1e-6 of each cell's Σ|v| on general
data (atomic adds land in any order), and BITWISE on dyadic data, where
every order gives the same sum — in every regime the launch plan can
pick: a feature group in one CTA, the same with replicas, several
feature groups or node ranges or bin chunks, one row per thread where
the row count is not a multiple of 4, and the row-partitioned regime
(with one or two feature groups, uint8 and int16 codes). The row
partition kernels must equal their plain version (a stable sort)
bitwise. The batched launch over K trees (kernel B3) is held to its
plain version bitwise on dyadic data, and its K=1 call to the
single-tree wrapper.
"""

import dataclasses

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch.ops import histogram as H


def _case(rows, F, n_nodes, n_bins, C, seed, dyadic=False,
          code_dtype=torch.uint8, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    binned = torch.randint(0, n_bins, (F, rows), generator=g).to(code_dtype)
    rel = torch.randint(0, n_nodes, (rows,), generator=g).to(torch.int32)
    rel[torch.rand(rows, generator=g) < 0.3] = -1
    if dyadic:
        vals = (torch.randint(-2, 3, (rows, C), generator=g) * 0.5).float()
    else:
        vals = torch.randn(rows, C, generator=g)
    vals[rel < 0] = 0.0
    return binned.to(device), rel.to(device), vals.to(device)


def _numpy_hist(binned, rel, vals, n_nodes, n_bins):
    b, r, v = binned.numpy().astype(np.int64), rel.numpy(), vals.numpy()
    live = r >= 0
    out = np.zeros((n_nodes, b.shape[0], n_bins, v.shape[1]))
    for f in range(b.shape[0]):
        np.add.at(out[:, f], (r[live], b[f, live]), v[live].astype(
            np.float64))
    return out


@pytest.mark.parametrize("C", [2, 3])
def test_plain_version_matches_numpy(C):
    binned, rel, vals = _case(3000, 4, 8, 64, C, seed=C)
    got = H.histogram_plain(binned, rel, vals, 8, 64).numpy()
    want = _numpy_hist(binned, rel, vals, 8, 64)
    scale = _numpy_hist(binned, rel, vals.abs(), 8, 64)
    assert got.shape == (8, 4, 64, C)
    assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_plain_version_is_exact_on_dyadic_data():
    binned, rel, vals = _case(5000, 3, 4, 32, 3, seed=1, dyadic=True)
    got = H.histogram_plain(binned, rel, vals, 4, 32).numpy()
    np.testing.assert_array_equal(got, _numpy_hist(binned, rel, vals, 4,
                                                   32))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (rows, F, n_nodes, n_bins, C, code dtype): the root (replicas), a
# depth-4 level (two groups), the AUC's 4096 int16 bins (replicas), 128
# and 256 nodes (partitioned), 1,024 nodes over 2 features (partitioned),
# 20,000 int16 bins (a node wider than one CTA: streamed in bin chunks),
# 28 features at an odd row count (one row per thread), 64 nodes at an
# odd row count (partitioned), 40 features (two groups), 40 features at
# 64 nodes (partitioned in two groups), 16 nodes of 4096 int16 bins
# (partitioned), one feature at 128 nodes (streamed over two node
# ranges)
_SHAPES = [(200_000, 10, 1, 256, 3, torch.uint8),
           (200_000, 10, 8, 256, 2, torch.uint8),
           (100_000, 1, 1, 4096, 3, torch.int16),
           (200_000, 3, 128, 256, 3, torch.uint8),
           (200_000, 2, 256, 256, 2, torch.uint8),
           (60_000, 2, 1024, 256, 3, torch.uint8),
           (50_000, 2, 2, 20_000, 3, torch.int16),
           (100_003, 28, 4, 64, 2, torch.uint8),
           (99_999, 5, 64, 256, 3, torch.uint8),
           (50_000, 40, 1, 256, 3, torch.uint8),
           (50_000, 40, 64, 256, 3, torch.uint8),
           (100_000, 2, 16, 4096, 3, torch.int16),
           (100_000, 1, 128, 256, 3, torch.uint8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(
    map(str, s[:5])))
def test_kernel_matches_plain_on_card(shape):
    dev = _card()
    rows, F, n, B, C, dt = shape
    binned, rel, vals = _case(rows, F, n, B, C, seed=7, code_dtype=dt,
                              device=dev)
    before = dict(H.LAUNCHES)
    got = H.build_histogram_kernel(binned, rel, vals, n, B)
    mode = H.hist_mode(1, n, F, B, C, binned.element_size(), rows)
    assert H.LAUNCHES == {**before, mode: before[mode] + 1}
    want = H.histogram_plain(binned, rel, vals, n, B)
    scale = H.histogram_plain(binned, rel, vals.abs(), n, B)
    assert got.shape == (n, F, B, C)
    assert ((got - want).abs() <= 1e-6 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(
    map(str, s[:5])))
def test_kernel_bitwise_on_dyadic_data(shape):
    dev = _card()
    rows, F, n, B, C, dt = shape
    binned, rel, vals = _case(rows, F, n, B, C, seed=9, dyadic=True,
                              code_dtype=dt, device=dev)
    got = H.build_histogram_kernel(binned, rel, vals, n, B)
    assert torch.equal(got, H.histogram_plain(binned, rel, vals, n, B))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    binned, rel, vals = _case(1000, 2, 2, 16, 3, seed=2, device=dev)
    with pytest.raises(TypeError):
        H.build_histogram_kernel(binned.float(), rel, vals, 2, 16)
    with pytest.raises(TypeError):
        H.build_histogram_kernel(binned, rel.long(), vals, 2, 16)
    with pytest.raises(ValueError):
        H.build_histogram_kernel(binned, rel, vals.cpu(), 2, 16)
    with pytest.raises(ValueError):
        H.build_histogram_kernel(binned.T.contiguous().T, rel, vals, 2, 16)
    with pytest.raises(ValueError):
        H.build_histogram_kernel(binned, rel, torch.zeros(
            1000, 4, device=dev), 2, 16)


# (K, rows, F, n_nodes, n_bins, C): DRF's forest levels of 32 left
# children and 64 (327,680 bytes per feature: past one SM's shared
# memory), its root (one group of 28 features), 2 channels; 4-class
# multinomial levels of 8 nodes and of the root, 3 channels; an odd row
# count
_BATCHED = [(10, 200_000, 4, 32, 64, 2), (10, 200_000, 4, 64, 64, 2),
            (10, 100_000, 28, 1, 64, 2), (4, 200_000, 3, 8, 256, 3),
            (4, 100_000, 10, 1, 256, 3), (10, 50_001, 6, 64, 64, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _BATCHED, ids=lambda s: "x".join(
    map(str, s)))
def test_batched_kernel_bitwise_on_dyadic_data(shape):
    dev = _card()
    K, rows, F, n, B, C = shape
    g = torch.Generator().manual_seed(K * n)
    binned = torch.randint(0, B, (F, rows), generator=g).to(torch.uint8)
    rel = torch.randint(-1, n, (K, rows), generator=g).to(torch.int32)
    vals = (torch.randint(-2, 3, (K, rows, C), generator=g) * 0.5).float()
    vals[rel < 0] = 0.0
    binned, rel, vals = binned.to(dev), rel.to(dev), vals.to(dev)
    before = dict(H.BATCHED_LAUNCHES)
    got = H.build_histogram_batched(binned, rel, vals, n, B)
    mode = H.hist_mode(K, n, F, B, C, rows=rows)
    assert H.BATCHED_LAUNCHES == {**before, mode: before[mode] + 1}
    assert got.shape == (K, n, F, B, C)
    assert torch.equal(got, H.histogram_batched_plain(binned, rel, vals, n,
                                                      B))


@pytest.mark.cuda
def test_k1_batched_call_equals_single_tree_kernel():
    dev = _card()
    binned, rel, vals = _case(200_000, 10, 8, 256, 3, seed=11, dyadic=True,
                              device=dev)
    one = H.build_histogram_kernel(binned, rel, vals, 8, 256)
    assert torch.equal(H.build_histogram_batched(
        binned, rel[None], vals[None], 8, 256)[0], one)
    assert torch.equal(one, H.histogram_plain(binned, rel, vals, 8, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 100_000, 28, 64, torch.uint8, 2),
                                   (1, 99_999, 10, 256, torch.uint8, 3),
                                   (4, 50_000, 3, 8, torch.int16, 3)],
                         ids=["drf", "gbm-odd", "int16"])
def test_row_partition_kernel_equals_its_plain_version(shape):
    dev = _card()
    K, rows, F, n, dt, C = shape
    g = torch.Generator().manual_seed(rows)
    binned = torch.randint(0, 200, (F, rows), generator=g).to(dt).to(dev)
    rel = torch.randint(-1, n + 1, (K, rows), generator=g).to(
        torch.int32).to(dev)
    vals = torch.randn(K, rows, C, generator=g).to(dev)
    stride = 16 * -(-F * binned.element_size() // 16)
    before = H.PARTITION_LAUNCHES["row_partition"]
    seg, codes, vs = H.row_partition(binned, rel, vals, n, stride)
    assert H.PARTITION_LAUNCHES["row_partition"] == before + 1
    want = H.row_partition_plain(binned, rel, vals, n, stride)
    live = int(want[0][-1])
    assert torch.equal(seg, want[0])
    assert torch.equal(codes[:live], want[1])
    assert torch.equal(vs[:live], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 200_000, 28, 16, 64, 2),
                                   (1, 200_000, 10, 64, 256, 3),
                                   (4, 100_001, 10, 4, 256, 3)],
                         ids=["drf", "gbm", "multinomial-odd"])
def test_both_regime_families_agree_bitwise(shape):
    """The same level through the streaming and the partitioned plan
    (pinned), and each streaming plan with 1 and 4 replicas: all equal
    to the plain version on dyadic data."""
    dev = _card()
    K, rows, F, n, B, C = shape
    g = torch.Generator().manual_seed(K * n + C)
    binned = torch.randint(0, B, (F, rows), generator=g).to(torch.uint8)
    rel = torch.randint(-1, n, (K, rows), generator=g).to(torch.int32)
    vals = (torch.randint(-2, 3, (K, rows, C), generator=g) * 0.5).float()
    vals[rel < 0] = 0.0
    binned, rel, vals = binned.to(dev), rel.to(dev), vals.to(dev)
    want = H.histogram_batched_plain(binned, rel, vals, n, B)
    stream = H._card_plan(binned, rel, vals, n, B, partition=False)
    slab = stream.smem_bytes // stream.replicas
    for plan in [H._card_plan(binned, rel, vals, n, B, partition=True)] + [
            dataclasses.replace(stream, replicas=R, smem_bytes=R * slab)
            for R in (1, 4)]:
        if plan.smem_bytes > H.BLOCK_SMEM:
            continue
        out = torch.zeros_like(want)
        H._launch(binned, rel, vals, out, plan)
        assert torch.equal(out, want), plan
