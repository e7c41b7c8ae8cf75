"""MLlib-convention estimators of the torch port."""

from .base import (Estimator, Model, Pipeline, PipelineModel, Transformer,
                   load_stage, save_stage)
from .classification import (BinaryLogisticRegressionSummary,
                             BinaryLogisticRegressionTrainingSummary,
                             LinearSVC, LinearSVCModel, LogisticRegression,
                             LogisticRegressionModel,
                             LogisticRegressionSummary,
                             LogisticRegressionTrainingSummary, NaiveBayes,
                             NaiveBayesModel, OneVsRest, OneVsRestModel)
from .clustering import (BisectingKMeans, BisectingKMeansModel,
                         GaussianMixture, GaussianMixtureModel,
                         GaussianMixtureSummary, KMeans, KMeansModel,
                         KMeansSummary, PowerIterationClustering)
from .evaluation import (BinaryClassificationEvaluator, ClusteringEvaluator,
                         Evaluator, MulticlassClassificationEvaluator,
                         RegressionEvaluator)
from .feature import VectorAssembler
from .glm import (GeneralizedLinearRegression,
                  GeneralizedLinearRegressionModel, GlmTrainingSummary)
from .linalg import Vectors
from .regression import (LinearRegression, LinearRegressionModel,
                         LinearRegressionSummary,
                         LinearRegressionTrainingSummary)
from .tree import (DecisionTreeClassificationModel, DecisionTreeClassifier,
                   DecisionTreeRegressionModel, DecisionTreeRegressor,
                   GBTClassificationModel, GBTClassifier,
                   GBTRegressionModel, GBTRegressor,
                   RandomForestClassificationModel, RandomForestClassifier,
                   RandomForestRegressionModel, RandomForestRegressor)
from .tuning import (CrossValidator, CrossValidatorModel, ParamGridBuilder,
                     TrainValidationSplit, TrainValidationSplitModel)
