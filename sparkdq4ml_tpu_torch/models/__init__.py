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
from .evaluation import (BinaryClassificationEvaluator, Evaluator,
                         MulticlassClassificationEvaluator,
                         RegressionEvaluator)
from .feature import VectorAssembler
from .linalg import Vectors
from .regression import (LinearRegression, LinearRegressionModel,
                         LinearRegressionSummary,
                         LinearRegressionTrainingSummary)
from .tuning import (CrossValidator, CrossValidatorModel, ParamGridBuilder,
                     TrainValidationSplit, TrainValidationSplitModel)
