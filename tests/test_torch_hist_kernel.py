"""PyTorch port, the histogram kernel wrapper on its own (no JAX here,
so the card-only cases also run where the JAX package is absent).

On the CPU the wrapper is its plain version, checked here against a
float64 numpy scatter. On a CUDA card (``-m cuda``) the kernel must
agree with the plain version within 1e-6 of each cell's Σ|v| on general
data (atomic adds land in any order), and BITWISE on dyadic data, where
every order gives the same sum — in both modes: the whole histogram in
one block's shared memory, and the node·bin range split across blocks.
The batched launch over K trees (kernel B3) is held to its plain
version bitwise on dyadic data, and its K=1 call to the single-tree
wrapper.
"""

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


# (rows, F, n_nodes, n_bins, C, code dtype): shared mode at the root,
# at a depth-4 level and for the AUC's 4096 int16 bins; split mode at
# 128 and 256 nodes
_SHAPES = [(200_000, 10, 1, 256, 3, torch.uint8),
           (200_000, 10, 8, 256, 2, torch.uint8),
           (100_000, 1, 1, 4096, 3, torch.int16),
           (200_000, 3, 128, 256, 3, torch.uint8),
           (200_000, 2, 256, 256, 2, torch.uint8)]


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
    mode = H.hist_mode(n, B, C)
    assert H.LAUNCHES[mode] == before[mode] + 1
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
# children (shared mode) and 64 (split mode), 2 channels; a 4-class
# multinomial level of 8 nodes, 3 channels
_BATCHED = [(10, 200_000, 4, 32, 64, 2), (10, 200_000, 4, 64, 64, 2),
            (4, 200_000, 3, 8, 256, 3)]


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
    mode = H.hist_mode(K * n, B, C)
    assert H.BATCHED_LAUNCHES[mode] == before[mode] + 1
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
