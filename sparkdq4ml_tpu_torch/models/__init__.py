"""MLlib-convention estimators of the torch port."""

from .base import Estimator, Model, Transformer
from .feature import VectorAssembler
from .linalg import Vectors
from .regression import (LinearRegression, LinearRegressionModel,
                         LinearRegressionSummary,
                         LinearRegressionTrainingSummary)
