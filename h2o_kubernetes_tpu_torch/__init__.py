"""PyTorch/CUDA port of h2o_kubernetes_tpu — GBM (every distribution of
the JAX package, checkpoint continuation), DRF and XGBoost-hist
(pointwise and LambdaMART ranking) training, GLM (IRLSM, L-BFGS,
coordinate descent; seven families), DeepLearning (MLP classifier and
regressor, autoencoder, checkpoint continuation), Word2Vec
(skip-gram with negative sampling), KMeans, PCA, GLRM, naive Bayes,
isolation forest, CoxPH, the aggregator and target encoding, MOJO-v2
export, the model registry and the scorer-replica serving path.

Data: ``import_file(path)`` parses CSV (pyarrow's streamed reader or
the pure-Python one), Parquet, ORC, Avro, SVMLight and ARFF into a
Frame on a device; a Frame filters, sorts, splits, joins, groups,
imputes and computes elementwise on its device (``frame/munge.py``),
and leaves as CSV (``export_file``) or a frame file (``save_frame``,
``load_frame``).

Training: ``Frame.from_arrays(...)`` puts a table on a device and
``GBM(...).train(y=..., training_frame=frame)`` or
``DRF(...).train(...)`` grows the trees there, building each level's
histograms — for all trees of a round or a forest group at once — with
a hand-written CUDA kernel on a card (``ops/histogram.py``,
``csrc/histogram.cu``); ``XGBoost(...)`` grows its trees through the
same grower, and ``GLM(...).train(...)`` solves its IRLS steps with
torch matmul and ``torch.linalg`` there. ``DeepLearning(...).train(...)``
steps an ``nn.Module`` MLP with autograd and ``torch.optim`` over
minibatches, and ``Word2Vec(...).train(frame)`` descends the
negative-sampling loss with scattered gradients, both on the frame's
device with the JAX package's random draws (``runtime/prng.py``, a
bitwise twin of ``jax.random``). ``KMeans``, ``PCA``, ``GLRM``,
``NaiveBayes``, ``IsolationForest``, ``CoxPH``, ``Aggregator`` and
``TargetEncoder`` train on the frame's device with matmuls, segment
sums and ``torch.linalg`` (none has a kernel of its own). Every
supervised estimator cross-validates with ``nfolds=``/``fold_column=``
(``models/cv.py``); ``StackedEnsemble`` stacks cross-validated models,
``GridSearch`` walks a hyper-parameter grid, and ``AutoML`` runs the
JAX package's model plan and two ensembles into a leaderboard on the
pipelined executor (``runtime/scheduler.py``). Serving: a scorer
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

Fleet: ``operator/`` turns replicas into a fleet — a reconciler that
spawns scorer pods (``python -m h2o_kubernetes_tpu_torch.operator.pod``,
each the REST replica on the card), places a tenant catalog across
shards (``ShardedPool``) and a front-door router
(``operator/router.py``) that forwards scoring to them, over a durable
pool store on any persist backend (local, ``mem://``, ``s3://``,
``gs://``, ``hdfs://``: ``persist_cloud.py``). ``init()``
(which joins a row group of one process per card when given a
coordinator), ``cluster_status()``, ``profile()``, ``device_memory()``,
``get_config()`` and ``set_config()`` are the JAX package's runtime
surface.

This package imports torch and never jax or h2o_kubernetes_tpu.
"""

from .automl import AutoML, Job, Leaderboard, jobs
from .config import get_config, set_config
from .diagnostics import device_memory, log, profile, timeline
from .frame import Frame, Vec, import_file, parse_setup
from .grid import GridSearch, H2OGridSearch
from .models.deeplearning import DeepLearning, DeepLearningModel
from .models.drf import DRF, DRFModel
from .models.gbm import GBM, GBMModel
from .models.aggregator import Aggregator, AggregatorModel
from .models.coxph import CoxPH, CoxPHModel
from .models.glm import GLM, GLMModel
from .models.glrm import GLRM, GLRMModel
from .models.isolationforest import IsolationForest, IsolationForestModel
from .models.kmeans import KMeans, KMeansModel
from .models.naivebayes import NaiveBayes, NaiveBayesModel
from .models.pca import PCA, PCAModel
from .models.targetencoder import TargetEncoder, TargetEncoderModel
from .models.stackedensemble import StackedEnsemble, StackedEnsembleModel
from .models.word2vec import Word2Vec, Word2VecModel
from .models.xgboost import XGBoost, XGBoostModel
from .mojo import MOJO_FORMAT, MojoModel, export_mojo, import_mojo, \
    read_mojo_parts
from .operator.registry import FlatTreeScorer, ModelRegistry, load_artifact
from .persist import (export_file, load_frame, load_model, save_frame,
                      save_model)
from .rest import start_server
from .runtime.backend import resolve_device

__version__ = "0.1.0"


def init(device=None, coordinator: str | None = None, **kw):
    """Resolve the device this process computes on (``None``: the CUDA
    card, raising without one; ``"cpu"`` the CPU) and return it; eager
    torch compiles nothing, so there is no compile cache to enable.

    With a ``coordinator`` (``host:port``; or ``H2O_TPU_COORDINATOR``
    with ``H2O_TPU_NUM_PROCESSES`` and ``H2O_TPU_PROCESS_ID``) the
    process first joins the row group (``runtime/mesh.
    initialize_distributed``; ``kw``: ``num_processes``,
    ``process_id``, ``backend``), one process per rank, and the rank's
    device is the group's: ``cuda:{process_id mod cards}`` by default,
    or ``device``."""
    from .runtime.mesh import initialize_distributed

    g = initialize_distributed(coordinator, device=device, **kw)
    return g.device if g.device is not None else resolve_device(device)


def cluster_status(device=None) -> dict:
    """``GET /3/Cloud``'s body for this process: the JAX package's keys.
    On a row group ``cloud_size`` and ``process_count`` are the world
    size and ``devices`` names every rank's device (gathered); alone,
    one process on one device."""
    import torch

    from .runtime.health import health_status
    from .runtime.mesh import global_mesh

    g = global_mesh()
    dev = g.device if g.device is not None else resolve_device(device)
    name = str(dev) if dev.type == "cpu" else \
        f"{dev} ({torch.cuda.get_device_name(dev)})"
    names = [name]
    if g.world_size > 1:
        import torch.distributed as dist

        names = [None] * g.world_size
        dist.all_gather_object(names, f"rank {g.rank}: {name}",
                               group=g.pg)
    return {"version": __version__,
            "cloud_healthy": bool(health_status()["healthy"]),
            "cloud_size": g.world_size, "mesh_shape": dict(g.shape),
            "process_count": g.world_size, "devices": names}


__all__ = ["GBM", "GBMModel", "DRF", "DRFModel", "XGBoost", "XGBoostModel",
           "GLM", "GLMModel", "DeepLearning", "DeepLearningModel",
           "Word2Vec", "Word2VecModel", "Frame", "FlatTreeScorer",
           "load_artifact", "start_server", "resolve_device",
           "read_mojo_parts", "MOJO_FORMAT", "export_mojo", "import_mojo",
           "MojoModel", "ModelRegistry", "save_model", "load_model", "Vec",
           "import_file", "parse_setup", "export_file", "save_frame",
           "load_frame", "AutoML", "Job", "Leaderboard", "jobs",
           "GridSearch", "H2OGridSearch", "StackedEnsemble",
           "StackedEnsembleModel", "KMeans", "KMeansModel", "PCA",
           "PCAModel", "GLRM", "GLRMModel", "NaiveBayes", "NaiveBayesModel",
           "IsolationForest", "IsolationForestModel", "CoxPH", "CoxPHModel",
           "Aggregator", "AggregatorModel", "TargetEncoder",
           "TargetEncoderModel", "init", "cluster_status", "get_config",
           "set_config", "profile", "device_memory", "log", "timeline"]
