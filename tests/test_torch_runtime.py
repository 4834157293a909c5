"""PyTorch port, serving runtime: device resolution, the device probe
and the heartbeat loop, the circuit breaker and device guard, the drain
path, the cordon, the fault sites (health.probe, train.step,
score.dispatch, lifecycle.drain), the retry policy, and the per-model
device-state cache counters (JAX-free, CPU)."""

import time

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
        health.stop_heartbeat(join=True)
        health.reset()
        lifecycle.reset()
        rest.BATCHER.stop(timeout=10)
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


def test_cordon_flips_readiness_not_admission(fresh_node):
    """A cordon takes the node out of readiness (``status`` names it)
    while scoring is still admitted; uncordon restores readiness."""
    blob = random_tree_artifact(45, n_features=4, ntrees=2, max_depth=2)
    m = load_artifact(blob, device="cpu")
    lifecycle.mark_serving()
    assert rest._ready_state()[0]
    lifecycle.cordon("rolling update")
    assert lifecycle.cordoned() == "rolling update"
    assert lifecycle.status()["cordoned"] == "rolling update"
    ready, reasons, _ = rest._ready_state()
    assert not ready and any("cordoned" in r for r in reasons)
    assert rest._ready_state(ignore_cordon=True)[0]
    X = random_rows(46, 10, 4)
    np.testing.assert_array_equal(rest.BATCHER.submit(m, X),
                                  m.score_numpy(X))
    lifecycle.uncordon()
    assert lifecycle.cordoned() is None and rest._ready_state()[0]
    lifecycle.cordon("x")
    lifecycle.reset()                     # a restart clears the cordon
    assert lifecycle.cordoned() is None


def test_heartbeat_loop_and_drain_joins_it(fresh_node):
    """start_heartbeat probes on its own thread; the drain stops and
    joins it before TERMINATED."""
    health.start_heartbeat(interval=0.02, timeout=10.0, device="cpu")
    deadline = time.monotonic() + 10.0
    while health.health_status()["beats"] < 2 and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    assert health.health_status()["beats"] >= 2
    loop = health._thread
    assert loop.name == "h2o-torch-heartbeat" and loop.is_alive()
    lifecycle.mark_serving()
    lifecycle.drain(reason="test", timeout=5.0)
    assert lifecycle.state() == lifecycle.TERMINATED
    assert not loop.is_alive()


def test_fault_sites(fresh_node, monkeypatch):
    """health.probe, train.step (not consumed by scoring),
    score.dispatch (feeds the breaker, node not locked) and
    lifecycle.drain (logged; the drain still completes)."""
    from h2o_kubernetes_tpu_torch import GBM, Frame
    from h2o_kubernetes_tpu_torch.runtime import faults

    with faults.inject("health.probe:error"):
        assert not health.heartbeat("cpu", timeout=10.0)
    assert "injected error" in health.health_status()["error"]
    health.reset()

    blob = random_tree_artifact(47, n_features=4, ntrees=2, max_depth=2)
    m = load_artifact(blob, device="cpu")
    X = random_rows(48, 10, 4)
    with faults.inject("train.step:device_error"):
        m.score_numpy(X)                  # scoring skips train.step
        fr = Frame.from_arrays({"x": [1.0, 2.0, 3.0, 4.0],
                                "y": ["a", "b", "a", "b"]}, device="cpu")
        with pytest.raises(faults.InjectedDeviceError):
            GBM(ntrees=1, max_depth=1, min_rows=1.0).train(
                y="y", training_frame=fr)
    assert not health.healthy()
    health.reset()

    monkeypatch.setenv("H2O_TPU_BREAKER_FAILURES", "2")
    with faults.inject("score.dispatch:dispatch_error*2"):
        for _ in range(2):
            with pytest.raises(health.ClusterHealthError,
                               match="transient dispatch failure"):
                m.score_numpy(X)
    assert lifecycle.BREAKER.state() == "open" and health.healthy()
    with pytest.raises(lifecycle.CircuitOpenError):
        m.contrib_numpy(X)
    lifecycle.BREAKER.reset()

    lifecycle.mark_serving()
    with faults.inject("lifecycle.drain:error"):
        lifecycle.drain(reason="test", timeout=5.0)
    assert lifecycle.state() == lifecycle.TERMINATED


def test_retry_policy_from_env_and_call(monkeypatch):
    """RetryPolicy's backoff, policy_from_env's knobs, and call's
    attempt cap, max-elapsed cap and drain-window give-up."""
    from h2o_kubernetes_tpu_torch.runtime import retry

    p = retry.RetryPolicy(base=0.5, max_delay=1.5, jitter=False)
    assert [p.backoff(a) for a in (1, 2, 3, 4)] == [0.5, 1.0, 1.5, 1.5]
    jp = retry.RetryPolicy(base=1.0)
    assert jp.backoff(1, rng=lambda: 0.0) == 0.5
    monkeypatch.setenv("H2O_TPU_RETRY_ATTEMPTS", "3")
    monkeypatch.setenv("H2O_TPU_RETRY_MAX_ELAPSED_S", "7")
    env = retry.policy_from_env()
    assert env.attempts == 3 and env.max_elapsed == 7.0
    monkeypatch.setenv("H2O_TPU_RETRY_DISABLE", "1")
    assert retry.policy_from_env().attempts == 1
    monkeypatch.delenv("H2O_TPU_RETRY_DISABLE")

    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise retry.TransientError("503", retry_after=0.25)
        return "ok"

    assert retry.call(flaky, retry.RetryPolicy(attempts=5),
                      sleep=sleeps.append) == "ok"
    assert sleeps == [0.25, 0.25]

    def always():
        calls.append(1)
        raise retry.TransientError("still down")

    calls.clear()
    with pytest.raises(retry.TransientError):
        retry.call(always, retry.RetryPolicy(attempts=4, jitter=False),
                   sleep=lambda s: None)
    assert len(calls) == 4
    calls.clear()                          # the max-elapsed cap
    with pytest.raises(retry.TransientError):
        retry.call(always, retry.RetryPolicy(attempts=9, base=5.0,
                                             jitter=False, max_elapsed=1.0),
                   sleep=lambda s: None)
    assert len(calls) == 1
    calls.clear()                          # a permanent error: no retry
    with pytest.raises(ValueError):
        retry.call(lambda: calls.append(1) or int("x"),
                   retry.RetryPolicy(), sleep=lambda s: None)
    assert len(calls) == 1
    # a draining node gives up instead of sleeping past its deadline
    monkeypatch.setattr(lifecycle, "remaining_drain_budget", lambda: 0.1)
    calls.clear()
    with pytest.raises(retry.TransientError):
        retry.call(always, retry.RetryPolicy(attempts=5, base=1.0,
                                             jitter=False),
                   sleep=lambda s: None)
    assert len(calls) == 1
