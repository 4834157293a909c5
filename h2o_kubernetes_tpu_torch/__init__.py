"""PyTorch/CUDA port of h2o_kubernetes_tpu — the scorer-replica serving
path.

A scorer replica loads a MOJO-v2 tree artifact (as written by the JAX
package's ``export_mojo``), scores rows with ``flat_margin`` and serves
per-row TreeSHAP contributions through a hand-written CUDA kernel
(``ops/shap_kernel.py``, ``csrc/shap_tab.cu``), over the REST
micro-batcher. Entry points take ``device=None``, meaning the CUDA
card; without one they raise unless the caller passes ``device="cpu"``.

This package imports torch and never jax or h2o_kubernetes_tpu.
"""

from .mojo import MOJO_FORMAT, read_mojo_parts
from .operator.registry import FlatTreeScorer, load_artifact
from .rest import start_server
from .runtime.backend import resolve_device

__version__ = "0.1.0"

__all__ = ["FlatTreeScorer", "load_artifact", "start_server",
           "resolve_device", "read_mojo_parts", "MOJO_FORMAT"]
