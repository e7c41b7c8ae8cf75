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
from .feature import (Binarizer, Bucketizer, ChiSqSelector,
                      ChiSqSelectorModel, DCT, ElementwiseProduct,
                      FeatureHasher, Imputer, ImputerModel,
                      IndexToString, Interaction, MaxAbsScaler,
                      MaxAbsScalerModel, MinMaxScaler, MinMaxScalerModel,
                      Normalizer, OneHotEncoder, OneHotEncoderEstimator,
                      OneHotEncoderModel, PCA,
                      PCAModel, PolynomialExpansion, QuantileDiscretizer,
                      RFormula, RFormulaModel, RobustScaler,
                      RobustScalerModel, SQLTransformer,
                      StandardScaler, StandardScalerModel, StringIndexer,
                      StringIndexerModel, VectorAssembler, VectorIndexer,
                      VectorIndexerModel, VectorSizeHint, VectorSlicer,
                      UnivariateFeatureSelector,
                      UnivariateFeatureSelectorModel,
                      VarianceThresholdSelector,
                      VarianceThresholdSelectorModel)
from .fm import (FMClassificationModel, FMClassifier, FMRegressionModel,
                 FMRegressor)
from .fpm import FPGrowth, FPGrowthModel, PrefixSpan
from .glm import (GeneralizedLinearRegression,
                  GeneralizedLinearRegressionModel, GlmTrainingSummary)
from .lda import LDA, LDAModel
from .linalg import Matrices, Vectors
from .lsh import (BucketedRandomProjectionLSH,
                  BucketedRandomProjectionLSHModel, MinHashLSH,
                  MinHashLSHModel)
from .regression import (IsotonicRegression, IsotonicRegressionModel,
                         LinearRegression, LinearRegressionModel,
                         LinearRegressionSummary,
                         LinearRegressionTrainingSummary)
from .stat import (ChiSquareTest, Correlation, KolmogorovSmirnovTest,
                   Summarizer)
from .survival import AFTSurvivalRegression, AFTSurvivalRegressionModel
from .tree import (DecisionTreeClassificationModel, DecisionTreeClassifier,
                   DecisionTreeRegressionModel, DecisionTreeRegressor,
                   GBTClassificationModel, GBTClassifier,
                   GBTRegressionModel, GBTRegressor,
                   RandomForestClassificationModel, RandomForestClassifier,
                   RandomForestRegressionModel, RandomForestRegressor)
from .tuning import (CrossValidator, CrossValidatorModel, ParamGridBuilder,
                     TrainValidationSplit, TrainValidationSplitModel)
from .word2vec import Word2Vec, Word2VecModel
