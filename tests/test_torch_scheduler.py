"""PyTorch port, the pipelined executor (``runtime/scheduler.py``) and
the pipelined fold loop (``models/cv.py``), with no JAX: the host
stream applies callbacks in submission order whatever order they are
submitted in, honours ``skip``, times out a wedged ``drain``, captures
task errors for ``pop_errors``, applies backpressure at
``H2O_TPU_AUTOML_QUEUE_DEPTH`` and joins its thread; the executor's
device token and stats; and the pipelined fold loop equals a serial
loop (one fold model after another, each scored as it finishes)
bitwise, on CPU frames.
"""

import threading
import time

import numpy as np
import pytest
import torch

from h2o_kubernetes_tpu_torch import GBM, GLM, Frame
from h2o_kubernetes_tpu_torch.models import cv as cvmod
from h2o_kubernetes_tpu_torch.models.base import score_predictions
from h2o_kubernetes_tpu_torch.runtime.scheduler import (HostStream,
                                                        PipelinedExecutor,
                                                        queue_depth)


@pytest.fixture
def stream():
    hs = HostStream(name="test-host")
    yield hs
    assert hs.stop(timeout=10.0)


def test_out_of_order_submission_applies_in_sequence(stream):
    out = []
    for seq in (3, 1, 0, 2, 4):
        stream.submit(seq, lambda s=seq: out.append(s), label=f"s{seq}")
    assert stream.drain(timeout=10.0) == []
    assert out == [0, 1, 2, 3, 4]
    assert stream.stats["applied"] == 5
    with pytest.raises(ValueError, match="already submitted"):
        stream.submit(2, lambda: None)


def test_skip_fills_a_gap(stream):
    out = []
    stream.submit(2, lambda: out.append(2))
    stream.submit(0, lambda: out.append(0))
    stream.skip(1)
    assert stream.drain(timeout=10.0) == []
    assert out == [0, 2] and stream.stats["skipped"] == 1


def test_drain_times_out_on_a_wedge_and_names_it(stream):
    stream.submit(1, lambda: None)              # seq 0 never comes
    with pytest.raises(TimeoutError, match="wedged at seq 0"):
        stream.drain(timeout=0.3)
    stream.skip(0)
    assert stream.drain(timeout=10.0) == []


def test_task_errors_are_captured_in_order(stream):
    def boom(msg):
        raise RuntimeError(msg)
    stream.submit(0, lambda: boom("a"), label="first")
    stream.submit(1, lambda: None)
    stream.submit(2, lambda: boom("b"), label="third")
    errs = stream.drain(timeout=10.0)
    assert [(s, lbl, str(e)) for s, lbl, e in errs] == [
        (0, "first", "a"), (2, "third", "b")]
    assert stream.pop_errors() == []


def test_backpressure_holds_the_producer(monkeypatch):
    monkeypatch.setenv("H2O_TPU_AUTOML_QUEUE_DEPTH", "2")
    assert queue_depth() == 2
    hs = HostStream(name="test-bp")
    gate = threading.Event()
    try:
        hs.submit(0, gate.wait)                 # the worker blocks here
        hs.submit(1, lambda: None)
        hs.submit(2, lambda: None)              # 2 pending: the limit
        t0 = time.monotonic()
        done = threading.Event()

        def producer():
            hs.submit(3, lambda: None)
            done.set()
        th = threading.Thread(target=producer)
        th.start()
        assert not done.wait(0.3)               # held while full
        gate.set()
        assert done.wait(10.0)
        th.join(10.0)
        assert not th.is_alive() and time.monotonic() - t0 >= 0.3
        assert hs.drain(timeout=10.0) == []
        assert hs.stats["max_pending"] == 2
    finally:
        gate.set()
        assert hs.stop(timeout=10.0)


def test_stop_joins_and_refuses_later_work():
    hs = HostStream(name="test-stop")
    hs.submit(0, lambda: None)
    assert hs.stop(timeout=10.0)
    assert not hs._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        hs.submit(1, lambda: None)


def test_executor_device_token_and_stats():
    ex = PipelinedExecutor()
    try:
        with ex.device("a"):
            time.sleep(0.05)
        ex.host.submit(0, lambda: time.sleep(0.02))
        ex.host.drain(timeout=10.0)
        st = ex.stats()
        assert st["device_steps"] == 1 and st["device_busy_s"] >= 0.05
        assert st["host_applied"] == 1 and st["host_busy_s"] >= 0.02
        assert st["wall_s"] >= st["device_busy_s"]
    finally:
        assert ex.shutdown(timeout=10.0)
    names = {t.name for t in threading.enumerate()}
    assert "h2o-torch-automl-host" not in names and \
        "h2o-torch-cv-host" not in names


def _serial_cv(est, y, frame, nfolds):
    """A serial fold loop: fold k trains on the other rows, predicts its
    own and is scored before fold k+1 starts."""
    import copy

    folds = cvmod.fold_ids(frame.nrows, nfolds, "modulo")
    ft = torch.as_tensor(folds)
    yv = frame.vec(y).as_float()
    preds, fms = None, []
    for k in range(nfolds):
        clone = copy.deepcopy(est)
        clone.cv_args = cvmod.CVArgs()
        m = clone.train(y=y, training_frame=frame.select_rows(ft != k))
        pk = m._predict_device(frame.select_rows(ft == k))
        if preds is None:
            preds = torch.zeros((frame.nrows,) + tuple(pk.shape[1:]))
        preds[ft == k] = pk
        yk = yv[ft == k]
        ok = ~torch.isnan(yk)
        fms.append(score_predictions(m.nclasses, m.distribution, yk[ok],
                                     pk[ok]))
    return preds, fms


def _frame(n=300, gaussian=False):
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, n)).astype(np.float32)
    y = a - 0.5 * b + 0.3 * rng.normal(size=n).astype(np.float32)
    cols = {"a": a, "b": b,
            "y": y if gaussian else np.where(y > 0, "p", "n")}
    return Frame.from_arrays(cols, device="cpu")


@pytest.mark.parametrize("case", ["gbm-binomial", "glm-gaussian"])
def test_pipelined_fold_loop_equals_serial_bitwise(case):
    gaussian = case.endswith("gaussian")
    fr = _frame(gaussian=gaussian)
    est = GBM(ntrees=3, max_depth=3, seed=4, nfolds=3,
              fold_assignment="modulo") if case.startswith("gbm") else \
        GLM(family="gaussian", nfolds=3, fold_assignment="modulo")
    m = est.train(y="y", training_frame=fr)
    preds, fms = _serial_cv(est, "y", fr, 3)
    assert torch.equal(m.cv.holdout_predictions, preds)
    assert m.cv.fold_metrics == fms
    assert not [t for t in threading.enumerate()
                if t.name == "h2o-torch-cv-host"]
