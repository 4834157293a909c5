"""DRF — distributed random forest on the shared histogram tree core.

``DRF(ntrees, max_depth, ...).train(y=..., training_frame=...)`` is the
JAX package's entry point (``h2o_kubernetes_tpu/models/drf.py``): per
tree a bootstrap row sample (``sample_rate``), per node ``mtries``
sampled features, and no boosting — trees fit the raw target
independently and predictions average across trees. With g = -y and
h = 1 the core's leaf value -G/H is the in-leaf mean of y, so
classification leaves hold P(class) directly, with no link function.

Forest trees are independent, so the core grows them in groups of G
(``core.drf_group_size``) through one batched histogram launch per
level. Every draw comes from the tree's own threefry key, keyed by the
JAX package's schedule: a seeded forest equals the JAX package's
grown on a one-row-shard mesh, whatever G is. ``checkpoint=<forest>``
grows a forest on to ``ntrees`` trees, walking the schedule from the
checkpoint's tree count; an offset column is refused, as in the JAX
package. Exclusive Feature Bundling (``H2O_TPU_EFB``) applies to forests
as to GBM; GOSS never does: a forest stays bagged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .gbm import GBM, GBMModel

__all__ = ["DRF", "DRFModel"]


class DRFModel(GBMModel):
    algo = "drf"


class DRF(GBM):
    """H2ORandomForestEstimator analog."""

    model_cls = DRFModel

    def __init__(self, ntrees: int = 50, max_depth: int = 12,
                 nbins: int = 64, sample_rate: float = 0.632,
                 mtries: int = -1, min_rows: float = 1.0, **kw):
        kw.setdefault("min_split_improvement", 1e-5)
        super().__init__(ntrees=ntrees, max_depth=max_depth, nbins=nbins,
                         sample_rate=sample_rate, min_rows=min_rows, **kw)
        self.params._drf_mode = True
        self.params.learn_rate = 1.0
        self._mtries_arg = mtries

    def _resolve_mtries(self, y: str, training_frame,
                        x: Sequence[str] | None, ignored_columns=None,
                        weights_column=None) -> None:
        """Resolve the mtries default into ``self.params`` from column
        names, as the JAX package does: -1 -> sqrt(F) for
        classification, F/3 for regression (at least 1); -2 -> every
        feature; > 0 -> that many."""
        ignored = set(ignored_columns or []) | {y}
        if self.cv_args.fold_column:
            ignored.add(self.cv_args.fold_column)
        if weights_column:
            ignored.add(weights_column)
        names = list(x) if x else [n for n in training_frame.names
                                   if n not in ignored]
        F = len(names)
        if self._mtries_arg == -1:
            m = int(np.sqrt(F)) if training_frame.vec(y).is_enum() \
                else max(F // 3, 1)
            self.params.mtries = max(m, 1)
        elif self._mtries_arg == -2:
            self.params.mtries = -1          # TreeParams: <= 0 disables
        elif self._mtries_arg > 0:
            self.params.mtries = self._mtries_arg
        else:
            raise ValueError(f"mtries must be -1, -2 or > 0, "
                             f"got {self._mtries_arg}")

    def train(self, y: str, training_frame, x: Sequence[str] | None = None,
              **kw) -> DRFModel:
        """Train on ``training_frame``'s device; returns the model."""
        if y not in training_frame:
            raise ValueError(f"response column '{y}' not in frame")
        self._resolve_mtries(y, training_frame, x, kw.get("ignored_columns"),
                             kw.get("weights_column"))
        return super().train(y=y, training_frame=training_frame, x=x, **kw)
