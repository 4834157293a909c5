"""h2o-py's estimator names for the port's learners:

    from h2o_kubernetes_tpu_torch.estimators import \\
        H2OGradientBoostingEstimator
    H2OGradientBoostingEstimator(ntrees=50).train(y=..., training_frame=...)
"""

from .automl import AutoML as H2OAutoML
from .models.aggregator import Aggregator
from .models.coxph import CoxPH
from .models.deeplearning import DeepLearning
from .models.drf import DRF
from .models.gbm import GBM
from .models.glm import GLM
from .models.glrm import GLRM
from .models.isolationforest import IsolationForest
from .models.kmeans import KMeans
from .models.naivebayes import NaiveBayes
from .models.pca import PCA
from .models.stackedensemble import StackedEnsemble
from .models.targetencoder import TargetEncoder
from .models.word2vec import Word2Vec
from .models.xgboost import XGBoost

H2OGradientBoostingEstimator = GBM
H2ORandomForestEstimator = DRF
H2OGeneralizedLinearEstimator = GLM
H2ODeepLearningEstimator = DeepLearning
H2OXGBoostEstimator = XGBoost
H2OWord2vecEstimator = Word2Vec
H2OStackedEnsembleEstimator = StackedEnsemble
H2OKMeansEstimator = KMeans
H2OPrincipalComponentAnalysisEstimator = PCA
H2ONaiveBayesEstimator = NaiveBayes
H2OIsolationForestEstimator = IsolationForest
H2OGeneralizedLowRankEstimator = GLRM
H2OCoxProportionalHazardsEstimator = CoxPH
H2OAggregatorEstimator = Aggregator
H2OTargetEncoderEstimator = TargetEncoder

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
