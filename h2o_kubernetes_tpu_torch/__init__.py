"""PyTorch/CUDA port of h2o_kubernetes_tpu — GBM (every distribution of
the JAX package, checkpoint continuation), DRF and XGBoost-hist
(pointwise and LambdaMART ranking) training, GLM (IRLSM, L-BFGS,
coordinate descent; seven families), MOJO-v2 export, the model registry
and the scorer-replica serving path.

Training: ``Frame.from_arrays(...)`` puts a table on a device and
``GBM(...).train(y=..., training_frame=frame)`` or
``DRF(...).train(...)`` grows the trees there, building each level's
histograms — for all trees of a round or a forest group at once — with
a hand-written CUDA kernel on a card (``ops/histogram.py``,
``csrc/histogram.cu``); ``XGBoost(...)`` grows its trees through the
same grower, and ``GLM(...).train(...)`` solves its IRLS steps with
torch matmul and ``torch.linalg`` there. Serving: a scorer
replica loads a MOJO-v2 tree artifact (as written by the JAX package's
``export_mojo``) or serves a trained model directly, scores rows with
``flat_margin`` and serves per-row TreeSHAP contributions through a
hand-written CUDA kernel (``ops/shap_kernel.py``, ``csrc/shap_tab.cu``),
over the REST micro-batcher. A trained model leaves its process as a
MOJO-v2 artifact (``export_mojo``; ``MojoModel`` scores one with numpy
only), published to a ``ModelRegistry`` and pushed to replicas, or as a
model file (``save_model``/``load_model``). Entry points take
``device=None``, meaning the CUDA card; without one they raise unless
the caller passes ``device="cpu"``.

This package imports torch and never jax or h2o_kubernetes_tpu.
"""

from .frame import Frame
from .models.drf import DRF, DRFModel
from .models.gbm import GBM, GBMModel
from .models.glm import GLM, GLMModel
from .models.xgboost import XGBoost, XGBoostModel
from .mojo import MOJO_FORMAT, MojoModel, export_mojo, import_mojo, \
    read_mojo_parts
from .operator.registry import FlatTreeScorer, ModelRegistry, load_artifact
from .persist import load_model, save_model
from .rest import start_server
from .runtime.backend import resolve_device

__version__ = "0.1.0"

__all__ = ["GBM", "GBMModel", "DRF", "DRFModel", "XGBoost", "XGBoostModel",
           "GLM", "GLMModel", "Frame", "FlatTreeScorer",
           "load_artifact", "start_server", "resolve_device",
           "read_mojo_parts", "MOJO_FORMAT", "export_mojo", "import_mojo",
           "MojoModel", "ModelRegistry", "save_model", "load_model"]
