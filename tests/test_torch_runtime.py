"""PyTorch port, serving runtime: device resolution, the device probe,
the circuit breaker and device guard, the drain path, and the
per-model device-state cache counters (JAX-free, CPU)."""

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch import load_artifact, rest
from h2o_kubernetes_tpu_torch.models.base import (model_scorer_counters,
                                                  scorer_cache_stats)
from h2o_kubernetes_tpu_torch.models.tree.synthetic import (
    random_rows, random_tree_artifact)
from h2o_kubernetes_tpu_torch.runtime import health, lifecycle
from h2o_kubernetes_tpu_torch.runtime.backend import resolve_device


@pytest.fixture
def fresh_node():
    """Health, breaker, lifecycle and batcher back to a clean STARTING
    node before and after (they are process-wide, as in the JAX
    package)."""
    def clean():
        health.reset()
        lifecycle.reset()
        rest.BATCHER.reset()
    clean()
    yield
    clean()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_heartbeat_probe_on_device(fresh_node):
    assert health.heartbeat("cpu", timeout=30.0)
    st = health.health_status()
    assert st["healthy"] and st["beats"] == 1 and st["last_beat"]


def test_device_errors_trip_the_breaker(fresh_node, monkeypatch):
    monkeypatch.setenv("H2O_TPU_BREAKER_FAILURES", "2")
    cuda_err = RuntimeError("CUDA error: an illegal memory access")
    assert health.is_device_error(cuda_err)
    assert health.is_device_error(torch.cuda.OutOfMemoryError("oom"))
    assert not health.is_device_error(ValueError("bad rows"))
    for _ in range(3):          # caller errors never count
        with pytest.raises(ValueError):
            with lifecycle.breaker_guard():
                raise ValueError("bad rows")
    assert lifecycle.BREAKER.state() == "closed"
    for _ in range(2):
        with pytest.raises(health.ClusterHealthError):
            with lifecycle.breaker_guard(), \
                    health.device_dispatch("scoring", locking=False):
                raise cuda_err
    assert lifecycle.BREAKER.state() == "open"
    assert health.healthy()               # serving errors do not lock
    with pytest.raises(lifecycle.CircuitOpenError):
        lifecycle.BREAKER.check()
    with pytest.raises(health.ClusterHealthError):
        with health.device_dispatch("training"):   # locking
            raise cuda_err
    assert not health.healthy()
    with pytest.raises(health.ClusterHealthError):
        health.require_healthy()


def test_drain_flushes_and_terminates(fresh_node):
    blob = random_tree_artifact(41, n_features=4, ntrees=3, max_depth=3)
    m = load_artifact(blob, device="cpu")
    X = random_rows(42, 50, 4)
    lifecycle.mark_serving()
    out = rest.BATCHER.submit(m, X, kind="contrib")
    np.testing.assert_array_equal(out, m.contrib_numpy(X))
    hooks = []
    lifecycle.register_shutdown(lambda: hooks.append(1))
    lifecycle.drain(reason="test", timeout=5.0)
    assert lifecycle.state() == lifecycle.TERMINATED and hooks == [1]
    assert lifecycle.wait_terminated(1.0)
    with pytest.raises(lifecycle.NodeDrainingError):
        rest.BATCHER.submit(m, X)


def test_warm_up_builds_device_state_once(fresh_node):
    """After warm_up(contributions=True), serving adds only cache hits:
    the device tensors are built once per model and kind."""
    blob = random_tree_artifact(43, n_features=5, ntrees=4, max_depth=4)
    m = load_artifact(blob, device="cpu")
    g0 = scorer_cache_stats()
    assert m.warm_up([300], contributions=True) == [128, 256, 512]
    c0 = model_scorer_counters(m)
    assert c0["misses"] == 2                 # score + contributions
    X = random_rows(44, 700, 5)
    m.score_numpy(X)
    m.contrib_numpy(X)
    c1 = model_scorer_counters(m)
    assert c1["misses"] == 2 and c1["hits"] == c0["hits"] + 2
    g1 = scorer_cache_stats()
    assert g1["models"] == g0["models"] + 1
    assert g1["misses"] - g0["misses"] == 2
