"""DeepLearning — MLP classifier/regressor and autoencoder on one device.

``DeepLearning(...).train(y=..., training_frame=...)`` is the JAX
package's entry point; it trains where the frame lives (the card by
default). The network is an ``nn.Module`` of ``nn.Linear`` layers over
the expanded design (``models/datainfo.py``, every level kept, the bias
in the layers), rectifier or tanh between them; each minibatch step
takes its gradient from autograd and its update from a fused
``torch.optim.Adam`` (``adaptive_rate``, optax's ``adam(rate)``: the
same moments, bias corrections and ε outside the square root) or
``torch.optim.SGD(momentum=...)`` (optax's ``sgd(rate, momentum)``).
A step's minibatch is one gather from a [rows, P + 2] table of the
inputs, the response and the weight.

The random draws are the JAX package's, through the threefry twin
(``runtime/prng.py``), in its order: ``key(seed)`` split once for the
init (He-normal weights, zero biases, one split per layer), then per
iteration one split, the row shard's ``fold_in`` (shard 0) and one key
per step; per step one split into the minibatch rows (``randint``) and
the dropout keys (``bernoulli`` masks, one per masked layer). An
iteration's draws are made before its steps, in batched twin calls over
its step keys, in chunks, so the step loop itself makes no draw and no
host sync.

The reference averages the shards' weights after each iteration (its
model-averaging allreduce); on one card that average is the identity,
so there is none here, and multi-shard averaging is not ported.
``nfolds``/``fold_column`` cross-validate (``models/cv.py``); an
autoencoder or a checkpoint continuation refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..runtime import prng
from .base import Model, TrainData, resolve_xy
from .datainfo import DataInfo, build_datainfo, design, expand

__all__ = ["DeepLearning", "DeepLearningModel", "DeepLearningParams",
           "carry_net", "deeplearning_model_from_arrays"]

# the most elements an iteration's draw tensors hold at once: the
# twin's int64 words of one chunk of steps stay near 256 MB
_DRAW_ELEMS = 1 << 25


@dataclass
class DeepLearningParams:
    hidden: tuple = (200, 200)
    activation: str = "rectifier"     # rectifier | tanh
    epochs: float = 10.0
    mini_batch_size: int = 32
    train_samples_per_iteration: int = -2   # -2: auto (one avg per epoch)
    adaptive_rate: bool = True        # adam; else momentum sgd
    rate: float = 0.005
    momentum_start: float = 0.9
    l1: float = 0.0
    l2: float = 0.0
    input_dropout_ratio: float = 0.0
    hidden_dropout_ratios: tuple | None = None
    autoencoder: bool = False
    standardize: bool = True
    seed: int = 0
    distribution: str = "auto"
    # continue training from a previous model: ``epochs`` is the TOTAL
    # target and must exceed the checkpoint's
    checkpoint: object = None


class MLP(nn.Module):
    """``sizes[0] -> ... -> sizes[-1]`` linear layers, the activation
    after each but the last; dropout masks, when given, scale the input
    and each hidden layer's output as the reference's ``_forward``."""

    def __init__(self, sizes: Sequence[int], activation: str):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))
        self.act = torch.tanh if activation == "tanh" else torch.relu

    def forward(self, x, masks=None):
        h = x
        if masks is not None and masks[0] is not None:
            keep, scale = masks[0]
            h = h * keep / scale
        for i, layer in enumerate(self.layers[:-1]):
            h = self.act(layer(h))
            if masks is not None and masks[i + 1] is not None:
                keep, scale = masks[i + 1]
                h = h * keep / scale
        return self.layers[-1](h)

    def hidden(self, x, layer: int):
        """The activations of hidden layer ``layer`` (0-based)."""
        h = x
        for lyr in self.layers[: layer + 1]:
            h = self.act(lyr(h))
        return h


def carry_net(net, device=None, activation: str = "rectifier") -> MLP:
    """An ``MLP`` holding another package's weights, given as the JAX
    package's ``[{"w": [in, out], "b": [out]}, ...]`` (numpy or
    array-likes); ``nn.Linear`` keeps ``[out, in]``, so each weight is
    transposed."""
    from ..runtime.backend import resolve_device

    dev = resolve_device(device)
    ws = [np.asarray(lyr["w"], dtype=np.float32) for lyr in net]
    sizes = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    mlp = MLP(sizes, activation).to(dev)
    with torch.no_grad():
        for layer, lyr, w in zip(mlp.layers, net, ws):
            layer.weight.copy_(torch.as_tensor(w.T.copy(), device=dev))
            layer.bias.copy_(torch.as_tensor(
                np.asarray(lyr["b"], dtype=np.float32), device=dev))
    return mlp


def _init_net(k: torch.Tensor, sizes, activation: str) -> MLP:
    """He-normal weights ``normal(k_i, (in, out)) · f32(sqrt(2 / in))``
    and zero biases, one split of the key per layer (the reference's
    ``_init_params``)."""
    mlp = MLP(sizes, activation).to(k.device)
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            k, ki = prng.split(k)
            scale = float(np.float32(np.sqrt(2.0 / sizes[i])))
            w = prng.normal(ki, (sizes[i], sizes[i + 1])) * scale
            layer.weight.copy_(w.t())
            layer.bias.zero_()
    return mlp


def _dropout_plan(p: DeepLearningParams, n_layers: int) -> list:
    """Per masked position (input, then each hidden layer): the drop
    ratio, or None where the reference draws no mask."""
    hid = p.hidden_dropout_ratios
    plan = [p.input_dropout_ratio if p.input_dropout_ratio > 0 else None]
    for i in range(n_layers - 1):
        plan.append(hid[i] if hid and hid[i] > 0 else None)
    return plan


def iteration_draws(ki: torch.Tensor, steps: int, batch: int, rows: int,
                    widths: Sequence[int], plan: Sequence, chunk: int):
    """The draws of one iteration, ``chunk`` steps at a time: yields
    (minibatch rows [c, batch] int64, per masked position the keep mask
    [c, batch, width] bool or None) for each chunk of its ``steps``
    step keys. ``widths`` are the masked positions' widths (the input,
    then each hidden layer), ``plan`` their drop ratios. The draws are
    the reference's (``fold_in(ki, 0)``, one key per step, each split
    into the rows' key and the dropout key; ``split(kdrop, n_layers +
    1)``, one key per position)."""
    ks = prng.split(prng.fold_in(ki, 0), steps)
    dropout = any(r is not None for r in plan)
    for s0 in range(0, steps, chunk):
        kk = prng.split(ks[s0:s0 + chunk])         # [c, 2, 2]
        idx = prng.randint(kk[:, 0], (batch,), 0, rows)
        masks = [None] * len(plan)
        if dropout:
            # [c, n_layers, 2]: split is prefix-stable, so these are the
            # first n_layers of the reference's n_layers + 1 keys
            dk = prng.split(kk[:, 1], len(plan))
            masks = [None if r is None else
                     prng.bernoulli(dk[:, j], 1 - r, (batch, widths[j]))
                     for j, r in enumerate(plan)]
        yield idx, masks


def _loss(out, yb, wb, loss_kind: str, net: MLP, l1: float, l2: float):
    """The reference's ``_loss_fn``: weighted cross-entropy over
    log-softmax, or weighted MSE divided by the output width; L1/L2 on
    the weights, never the biases."""
    if loss_kind == "ce":
        logp = torch.log_softmax(out, dim=1)
        nll = -logp.gather(1, yb.long()[:, None])[:, 0]
        loss = torch.sum(wb * nll) / (torch.sum(wb) + 1e-10)
    else:
        err = out - (yb if yb.dim() == 2 else yb[:, None])
        loss = torch.sum(wb[:, None] * err * err) / \
            (torch.sum(wb) + 1e-10) / err.shape[1]
    if l1:
        loss = loss + l1 * sum(torch.sum(torch.abs(lyr.weight))
                               for lyr in net.layers)
    if l2:
        loss = loss + l2 * sum(torch.sum(lyr.weight ** 2)
                               for lyr in net.layers)
    return loss


def _optimizer(p: DeepLearningParams, net: MLP):
    """Adam (``adaptive_rate``) or momentum SGD, fused: one kernel
    updates every parameter."""
    if p.adaptive_rate:
        return torch.optim.Adam(net.parameters(), lr=p.rate, fused=True)
    return torch.optim.SGD(net.parameters(), lr=p.rate,
                           momentum=p.momentum_start, fused=True)


class DeepLearningModel(Model):
    """A trained network (``net``, an ``MLP`` on the model's device), its
    design layout and loss."""

    algo = "deeplearning"
    _score_state = "_dl_state"

    def __init__(self, data: TrainData, params: DeepLearningParams,
                 dinfo: DataInfo, net: MLP, loss_kind: str):
        self.feature_names = list(data.feature_names)
        self.feature_domains = dict(data.feature_domains)
        self.nclasses = data.nclasses
        self.response_domain = data.response_domain
        self.distribution = data.distribution
        self.offset_column: str | None = None
        self.params = params
        self.dinfo = dinfo
        self.net = net
        self.loss_kind = loss_kind
        self.device = next(net.parameters()).device
        self.scoring_history: list[dict] = []
        self.validation_metrics: dict | None = None

    def net_numpy(self) -> list[dict]:
        """The weights as the JAX package holds them: ``[{"w": [in,
        out], "b": [out]}, ...]`` float32 numpy."""
        return [{"w": lyr.weight.detach().t().cpu().numpy().copy(),
                 "b": lyr.bias.detach().cpu().numpy().copy()}
                for lyr in self.net.layers]

    def _serving_prepare(self):
        """(means, stds) on the model's device, built once."""
        st = self.__dict__.get("_dl_state")
        if st is None:
            st = (torch.as_tensor(self.dinfo.means, device=self.device),
                  torch.as_tensor(self.dinfo.stds, device=self.device))
            self._dl_state = st
        return st

    def _expanded(self, X: torch.Tensor) -> torch.Tensor:
        """[rows, P] expanded design without the intercept column (the
        bias lives in the layers)."""
        means, stds = self._serving_prepare()
        d = self.dinfo
        return expand(X, means, stds, tuple(d.numeric_idx),
                      tuple(tuple(s) for s in d.enum_specs),
                      d.drop_first)[:, :-1]

    @torch.no_grad()
    def _score_matrix(self, X: torch.Tensor, offset=None) -> torch.Tensor:
        out = self.net(self._expanded(X))
        if self.loss_kind == "ce":
            return torch.softmax(out, dim=1)
        if self.params.autoencoder:
            return out
        if offset is not None:
            # the net was fit to y - offset; predictions add it back
            return out[:, 0] + offset
        return out[:, 0]

    def predict(self, frame):
        """An autoencoder gives its reconstruction, one ``reconstr_*``
        column per expanded input; otherwise the H2O prediction frame."""
        if self.params.autoencoder:
            from ..frame import Frame

            rec = self.predict_raw(frame)
            names = self.dinfo.coef_names[:-1]      # minus the intercept
            return Frame.from_arrays(
                {f"reconstr_{n}": rec[:, i] for i, n in enumerate(names)},
                device="cpu")
        return super().predict(frame)

    def model_performance(self, frame, y: str | None = None) -> dict:
        """An autoencoder's is its mean reconstruction MSE."""
        if self.params.autoencoder:
            return {"mse": float(np.mean(self.anomaly(frame)))}
        return super().model_performance(frame, y)

    @torch.no_grad()
    def anomaly(self, frame) -> np.ndarray:
        """Autoencoder per-row reconstruction MSE (anomaly score)."""
        if not self.params.autoencoder:
            raise ValueError("anomaly() requires autoencoder=True")
        Xe = self._expanded(self._design_matrix(frame))
        rec = self.net(Xe)
        return torch.mean((rec - Xe) ** 2, dim=1).cpu().numpy()

    @torch.no_grad()
    def deepfeatures(self, frame, layer: int) -> np.ndarray:
        """Hidden layer ``layer``'s activations (0-based)."""
        Xe = self._expanded(self._design_matrix(frame))
        return self.net.hidden(Xe, layer).cpu().numpy()

    @property
    def _artifact_meta(self) -> dict:
        """The MOJO-v2 meta of this model (the JAX package's DL
        fields)."""
        d = self.dinfo
        return {"algo": "deeplearning", "feature_names": self.feature_names,
                "feature_domains": self.feature_domains,
                "nclasses": self.nclasses,
                "response_domain": self.response_domain,
                "distribution": self.distribution,
                "offset_column": self.offset_column,
                "activation": self.params.activation,
                "loss_kind": self.loss_kind,
                "autoencoder": bool(self.params.autoencoder),
                "n_layers": len(self.net.layers),
                "numeric_idx": [int(i) for i in d.numeric_idx],
                "enum_specs": [[int(i), int(L), bool(na), int(m)]
                               for i, L, na, m in d.enum_specs],
                "drop_first": bool(d.drop_first)}

    @property
    def _artifact_arrays(self) -> dict:
        arrays = {"means": np.asarray(self.dinfo.means),
                  "stds": np.asarray(self.dinfo.stds)}
        for i, lyr in enumerate(self.net_numpy()):
            arrays[f"net_{i}_w"] = lyr["w"]
            arrays[f"net_{i}_b"] = lyr["b"]
        return arrays


class DeepLearning:
    """H2ODeepLearningEstimator analog."""

    def __init__(self, **kw):
        from .cv import CVArgs

        self.cv_args = CVArgs.pop(kw)
        self.params = DeepLearningParams(**kw)
        if self.cv_args.enabled and self.params.autoencoder:
            raise ValueError(
                "cross-validation is not supported for autoencoders")
        if self.cv_args.enabled and self.params.checkpoint is not None:
            raise ValueError(
                "checkpoint cannot be combined with cross-validation")

    def train(self, y: str | None = None, training_frame=None,
              x: Sequence[str] | None = None,
              ignored_columns: Sequence[str] | None = None,
              weights_column: str | None = None,
              validation_frame=None,
              offset_column: str | None = None) -> DeepLearningModel:
        """Train on ``training_frame``'s device; returns the model."""
        p = self.params
        if offset_column and p.autoencoder:
            raise ValueError(
                "offset_column is not supported for autoencoders")
        if self.cv_args.fold_column:
            ignored_columns = list(ignored_columns or []) + \
                [self.cv_args.fold_column]
        if p.autoencoder:
            if y is None:
                # unsupervised: a constant response for resolve_xy
                from ..frame import Frame, Vec

                y = "__ae_const__"
                training_frame = Frame(dict(training_frame._vecs))
                training_frame[y] = Vec.from_numpy(
                    np.zeros(training_frame.nrows, dtype=np.float32), y,
                    device=training_frame.device)
            data = resolve_xy(training_frame, y, x, ignored_columns,
                              weights_column, "gaussian")
        else:
            data = resolve_xy(training_frame, y, x, ignored_columns,
                              weights_column, p.distribution, offset_column)
        if offset_column and data.nclasses >= 2:
            # a per-row offset on every softmax logit is invariant: only
            # the regression (mse) head can honor it
            raise ValueError("offset_column is only supported for "
                             "regression DeepLearning")
        ck = p.checkpoint
        if ck is not None:
            if ck.feature_names != data.feature_names or \
                    ck.feature_domains != data.feature_domains:
                raise ValueError(
                    "checkpoint model was trained on different features/"
                    "domains")
            if (getattr(ck, "offset_column", None) or None) != \
                    (offset_column or None):
                raise ValueError(
                    "checkpoint offset_column mismatch: "
                    f"{getattr(ck, 'offset_column', None)!r} vs "
                    f"{offset_column!r}")
            # the checkpoint's standardization: recomputing it on this
            # frame would rescale every input its weights were fit to
            dinfo = ck.dinfo
        else:
            dinfo = build_datainfo(data, training_frame, p.standardize,
                                   drop_first=False)
        Xe = dinfo.expand(design(training_frame, data.feature_names))[:, :-1]
        dev = Xe.device
        Pn = Xe.shape[1]
        K = data.nclasses
        if p.autoencoder:
            loss_kind, out_dim = "mse", Pn
        elif K >= 2:
            loss_kind, out_dim = "ce", K
        else:
            loss_kind, out_dim = "mse", 1
        sizes = (Pn,) + tuple(p.hidden) + (out_dim,)
        key, kinit = prng.split(prng.key(p.seed, device=dev))
        if ck is not None:
            got = tuple(lyr.in_features for lyr in ck.net.layers) + \
                (ck.net.layers[-1].out_features,)
            if got != sizes:
                raise ValueError(f"checkpoint layer sizes {got} != {sizes}")
            net = MLP(sizes, p.activation).to(dev)
            net.load_state_dict(ck.net.state_dict())
        else:
            net = _init_net(kinit, sizes, p.activation)

        rows = Xe.shape[0]
        batch = min(p.mini_batch_size, rows)
        samples_per_iter = p.train_samples_per_iteration \
            if p.train_samples_per_iteration > 0 else data.nrows
        local_steps = max(1, samples_per_iter // batch)
        if ck is not None:
            prev_epochs = ck.params.epochs
            if p.epochs <= prev_epochs:
                raise ValueError(
                    f"epochs ({p.epochs}) must exceed the checkpoint "
                    f"model's ({prev_epochs}) — epochs is the total "
                    f"training target, not an increment")
            total_samples = (p.epochs - prev_epochs) * data.nrows
        else:
            total_samples = p.epochs * data.nrows
        n_iters = max(1, int(round(total_samples / (local_steps * batch))))
        # one [rows, P + 2] table of inputs, response and weight, so a
        # step's minibatch is one gather (an autoencoder's response is
        # its input)
        y_dev = data.y
        if data.offset is not None and not p.autoencoder:
            # fit the net to y - offset; scoring adds the offset back
            y_dev = y_dev - data.offset
        table = torch.cat([Xe, y_dev[:, None], data.w[:, None]], dim=1)
        opt = _optimizer(p, net)
        plan = _dropout_plan(p, len(sizes) - 1)
        widths = sizes[:-1]
        scales = [None if r is None else
                  torch.tensor(np.float32(1 - r), device=dev) for r in plan]
        dropout = any(r is not None for r in plan)
        chunk = max(1, _DRAW_ELEMS // (batch * (max(widths) if dropout
                                                else 1)))
        for _ in range(n_iters):
            key, ki = prng.split(key)
            for idx, masks in iteration_draws(ki, local_steps, batch, rows,
                                              widths, plan, chunk):
                for s in range(idx.shape[0]):
                    b = table.index_select(0, idx[s])
                    xb = b[:, :Pn]
                    ms = [None if m is None else (m[s], sc)
                          for m, sc in zip(masks, scales)] \
                        if dropout else None
                    out = net(xb, ms)
                    loss = _loss(out, xb if p.autoencoder else b[:, Pn],
                                 b[:, Pn + 1], loss_kind, net, p.l1, p.l2)
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
            # one row shard: the reference's average of the shards'
            # weights (psum / n) is the identity here

        model = DeepLearningModel(data, p, dinfo, net, loss_kind)
        model.offset_column = offset_column
        if p.autoencoder:
            model.nclasses = 1
            if validation_frame is not None:
                model.validation_metrics = model.model_performance(
                    validation_frame)
            return model
        if data.nrows <= 100_000 and not _offset_has_na(
                training_frame, offset_column):
            # one full-frame row at train end (H2O scores a sample at
            # intervals), skipped past 100,000 rows
            perf = model.model_performance(training_frame, y)
            model.scoring_history = [{
                "epochs": p.epochs,
                **{f"train_{k}": v for k, v in perf.items()}}]
        from .cv import finalize_train

        return finalize_train(
            self, model, y, training_frame,
            {"x": x, "ignored_columns": ignored_columns,
             "weights_column": weights_column,
             "offset_column": offset_column},
            validation_frame)


def _offset_has_na(frame, offset_column) -> bool:
    """NA offsets make NaN predictions by design (training dropped those
    rows) and would poison frame-level metrics."""
    if offset_column is None:
        return False
    return bool(torch.isnan(frame.vec(offset_column).as_float()).any())


def deeplearning_model_from_arrays(
        net, coef_names: list[str], numeric_idx, enum_specs, means, stds,
        feature_names: list[str], loss_kind: str,
        response_domain: list[str] | None = None,
        feature_domains: dict | None = None, nclasses: int | None = None,
        distribution: str = "gaussian", offset_column: str | None = None,
        device=None, **params) -> DeepLearningModel:
    """A port ``DeepLearningModel`` from another package's trained
    network, as numpy: ``net`` (``[{"w": [in, out], "b": [out]}]``), the
    ``DataInfo`` arrays (every level kept) and the loss (``"ce"`` or
    ``"mse"``); ``params`` are DeepLearningParams fields (``epochs`` the
    source's, so the model continues as a checkpoint). The model scores
    and exports as the source model does."""
    p = DeepLearningParams(**params)
    mlp = carry_net(net, device, p.activation)
    dinfo = DataInfo(list(coef_names), [int(i) for i in numeric_idx],
                     [tuple(int(v) if j != 2 else bool(v)
                            for j, v in enumerate(s)) for s in enum_specs],
                     np.asarray(means, dtype=np.float32),
                     np.asarray(stds, dtype=np.float32),
                     len(coef_names), False)
    if nclasses is None:
        nclasses = mlp.layers[-1].out_features if loss_kind == "ce" else 1
    data = TrainData(list(feature_names), torch.zeros(0), torch.zeros(0), 0,
                     nclasses, response_domain, distribution,
                     dict(feature_domains or {}))
    model = DeepLearningModel(data, p, dinfo, mlp, loss_kind)
    model.offset_column = offset_column
    return model
