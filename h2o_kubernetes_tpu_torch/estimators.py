"""h2o-py's estimator names for the port's learners:

    from h2o_kubernetes_tpu_torch.estimators import \\
        H2OGradientBoostingEstimator
    H2OGradientBoostingEstimator(ntrees=50).train(y=..., training_frame=...)

The names of learners the port does not have yet (k-means, PCA, GLRM,
naive Bayes, isolation forest, CoxPH, the aggregator and the target
encoder) raise ``NotImplementedError`` naming ROADMAP Queue 1 item 12,
which ports them.
"""

from .automl import AutoML as H2OAutoML
from .models.deeplearning import DeepLearning
from .models.drf import DRF
from .models.gbm import GBM
from .models.glm import GLM
from .models.stackedensemble import StackedEnsemble
from .models.word2vec import Word2Vec
from .models.xgboost import XGBoost

H2OGradientBoostingEstimator = GBM
H2ORandomForestEstimator = DRF
H2OGeneralizedLinearEstimator = GLM
H2ODeepLearningEstimator = DeepLearning
H2OXGBoostEstimator = XGBoost
H2OWord2vecEstimator = Word2Vec
H2OStackedEnsembleEstimator = StackedEnsemble


def _unported(name: str, learner: str) -> type:
    def __init__(self, *args, **kw):
        raise NotImplementedError(
            f"{learner} is not ported (ROADMAP Queue 1 item 12)")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"{learner}: not ported yet."})


H2OKMeansEstimator = _unported("H2OKMeansEstimator", "KMeans")
H2OPrincipalComponentAnalysisEstimator = _unported(
    "H2OPrincipalComponentAnalysisEstimator", "PCA")
H2ONaiveBayesEstimator = _unported("H2ONaiveBayesEstimator", "NaiveBayes")
H2OIsolationForestEstimator = _unported("H2OIsolationForestEstimator",
                                        "IsolationForest")
H2OGeneralizedLowRankEstimator = _unported(
    "H2OGeneralizedLowRankEstimator", "GLRM")
H2OCoxProportionalHazardsEstimator = _unported(
    "H2OCoxProportionalHazardsEstimator", "CoxPH")
H2OAggregatorEstimator = _unported("H2OAggregatorEstimator", "Aggregator")
H2OTargetEncoderEstimator = _unported("H2OTargetEncoderEstimator",
                                      "TargetEncoder")

__all__ = [
    "H2OAutoML", "H2OGradientBoostingEstimator",
    "H2ORandomForestEstimator", "H2OGeneralizedLinearEstimator",
    "H2ODeepLearningEstimator", "H2OXGBoostEstimator",
    "H2OWord2vecEstimator", "H2OStackedEnsembleEstimator",
    "H2OKMeansEstimator", "H2OPrincipalComponentAnalysisEstimator",
    "H2ONaiveBayesEstimator", "H2OIsolationForestEstimator",
    "H2OGeneralizedLowRankEstimator",
    "H2OCoxProportionalHazardsEstimator", "H2OAggregatorEstimator",
    "H2OTargetEncoderEstimator",
]
