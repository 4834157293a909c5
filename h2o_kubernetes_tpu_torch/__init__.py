"""PyTorch/CUDA port of h2o_kubernetes_tpu — GBM (binomial, gaussian,
multinomial) and DRF training, and the scorer-replica serving path.

Training: ``Frame.from_arrays(...)`` puts a table on a device and
``GBM(...).train(y=..., training_frame=frame)`` or
``DRF(...).train(...)`` grows the trees there, building each level's
histograms — for all trees of a round or a forest group at once — with
a hand-written CUDA kernel on a card (``ops/histogram.py``,
``csrc/histogram.cu``). Serving: a scorer
replica loads a MOJO-v2 tree artifact (as written by the JAX package's
``export_mojo``) or serves a trained model directly, scores rows with
``flat_margin`` and serves per-row TreeSHAP contributions through a
hand-written CUDA kernel (``ops/shap_kernel.py``, ``csrc/shap_tab.cu``),
over the REST micro-batcher. Entry points take ``device=None``, meaning
the CUDA card; without one they raise unless the caller passes
``device="cpu"``.

This package imports torch and never jax or h2o_kubernetes_tpu.
"""

from .frame import Frame
from .models.drf import DRF, DRFModel
from .models.gbm import GBM, GBMModel
from .mojo import MOJO_FORMAT, read_mojo_parts
from .operator.registry import FlatTreeScorer, load_artifact
from .rest import start_server
from .runtime.backend import resolve_device

__version__ = "0.1.0"

__all__ = ["GBM", "GBMModel", "DRF", "DRFModel", "Frame", "FlatTreeScorer",
           "load_artifact", "start_server", "resolve_device",
           "read_mojo_parts", "MOJO_FORMAT"]
