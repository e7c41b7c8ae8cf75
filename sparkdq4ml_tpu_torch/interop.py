"""Carrying state between the JAX package and the port through numpy: the
same seeded data feeds both, and a model fitted in one predicts in the
other. Saved stages need nothing here: both packages write one on-disk
format, so ``models.load_stage`` (or ``PipelineModel.load``,
``LinearRegressionModel.load``) reads a directory the JAX package saved.

A fitted classifier crosses as its constructor arguments:
:func:`classifier_to_numpy` reads them off a model of either package (the
two share attribute names), and :func:`classifier_from_numpy` builds the
port's model from them; the JAX package's class of the same name takes
them as keyword arguments.

The model zoo crosses the same way: :func:`glm_model_from_numpy`,
:func:`tree_model_from_numpy`, :func:`kmeans_model_from_numpy` and
:func:`gmm_model_from_numpy` build the port's model from a JAX model's
fitted parameters as numpy arrays, so one fitted model scores in both
packages.

The feature layer's fitted models cross through their persisted
attributes: :func:`feature_model_to_numpy` reads them off a model of
either package and :func:`feature_model_from_numpy` builds the port's
model from them.

The rest of ``models/`` crosses as arrays too: :func:`als_model_from_numpy`,
:func:`mlp_model_from_numpy`, :func:`count_vectorizer_model_from_numpy` and
:func:`idf_model_from_numpy` build the port's model from a JAX model's
factors and ids, weights, vocabulary or IDF weights."""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import numpy as np

from .frame.frame import Frame
from .models.clustering import GaussianMixtureModel, KMeansModel
from .models.classification import (LinearSVCModel,
                                    LogisticRegressionModel,
                                    NaiveBayesModel, OneVsRestModel)
from .models.glm import GeneralizedLinearRegressionModel
from .models.regression import LinearRegressionModel
from .models import tree as _tree
from .models.tuning import CrossValidatorModel


def frame_from_numpy(columns: Mapping[str, np.ndarray], mask=None,
                     device=None) -> Frame:
    """A frame of numpy columns (and an optional boolean mask) on
    ``device``, by default the active session's."""
    return Frame({k: np.asarray(v) for k, v in columns.items()},
                 mask=None if mask is None else np.asarray(mask, bool),
                 device=device)


WORDS = ("amber", "Beta", "cobalt", "delta", "ember", "fir", "", "b_a",
         "b%a", "éclair")


def string_columns(n: int, seed: int = 0, null_share: float = 0.1) -> dict:
    """A seeded table with string and array columns, as numpy arrays that
    both packages' frames take: ``name`` (object strings from ``WORDS``,
    about ``null_share`` of them None), ``tags`` (object array cells:
    lists of 0 to 3 words, some None), ``k`` (int32 in [0, 5)) and ``v``
    (float64, some NaN)."""
    rng = np.random.default_rng(seed)
    name = np.asarray(rng.choice(np.asarray(WORDS, dtype=object), n),
                      dtype=object)
    name[rng.random(n) < null_share] = None
    tags = np.empty(n, dtype=object)
    for i in range(n):
        tags[i] = (None if rng.random() < null_share else
                   [str(w) for w in rng.choice(WORDS,
                                               int(rng.integers(0, 4)))])
    v = rng.normal(10.0, 5.0, n)
    v[rng.random(n) < null_share] = np.nan
    return {"name": name, "tags": tags,
            "k": rng.integers(0, 5, n).astype(np.int32), "v": v}


def linear_model_from_numpy(coefficients, intercept: float,
                            params: Optional[dict] = None,
                            scale: float = 1.0) -> LinearRegressionModel:
    """A ``LinearRegressionModel`` from host coefficients, such as
    ``np.asarray`` of a JAX model's. ``params`` uses the estimator's
    snake_case names (``reg_param``, ``features_col``, ...); ``scale`` is a
    Huber model's fitted sigma."""
    return LinearRegressionModel(np.asarray(coefficients),
                                 float(intercept), params, scale=scale)


def cv_model_from_numpy(best_model, avg_metrics, best_index: int
                        ) -> CrossValidatorModel:
    """A ``CrossValidatorModel`` from a best model (a port model) and the
    reference's ``avg_metrics``/``best_index`` as numpy."""
    return CrossValidatorModel(best_model, np.asarray(avg_metrics, np.float64),
                               int(best_index))


_CLASSIFIERS = {c.__name__: c for c in (LogisticRegressionModel,
                                        LinearSVCModel, NaiveBayesModel,
                                        OneVsRestModel)}


def classifier_to_numpy(model) -> dict:
    """A fitted ``LogisticRegressionModel``, ``LinearSVCModel``,
    ``NaiveBayesModel`` or ``OneVsRestModel`` of either package as
    ``{"class": name, **constructor keyword arguments}``, arrays as numpy
    (a one-vs-rest model's ``models`` as such dicts in turn)."""
    name = type(model).__name__
    params = dict(getattr(model, "_params", {}))
    if name == "LogisticRegressionModel":
        if model.is_multinomial:
            return {"class": name, "params": params,
                    "coefficient_matrix": np.array(model.coefficient_matrix),
                    "intercept_vector": np.array(model.intercept_vector)}
        return {"class": name, "params": params,
                "coefficients": np.array(model.coefficients),
                "intercept": float(model.intercept)}
    if name == "LinearSVCModel":
        return {"class": name, "params": params,
                "coefficients": np.array(model.coefficients),
                "intercept": float(model.intercept),
                "objective_history": list(model.objective_history),
                "iterations": int(model.iterations)}
    if name == "NaiveBayesModel":
        return {"class": name, "params": params, "pi": np.array(model.pi),
                "theta": np.array(model.theta),
                "model_type": model.model_type}
    if name == "OneVsRestModel":
        return {"class": name,
                "models": [classifier_to_numpy(m) for m in model.models],
                "features_col": model.features_col,
                "prediction_col": model.prediction_col}
    raise TypeError(f"not a classifier model: {name}")


def classifier_from_numpy(state: dict):
    """The port's model of :func:`classifier_to_numpy`'s dict."""
    kwargs = {k: v for k, v in state.items() if k != "class"}
    if state["class"] == "OneVsRestModel":
        kwargs["models"] = [classifier_from_numpy(m)
                            for m in kwargs["models"]]
    return _CLASSIFIERS[state["class"]](**kwargs)


def glm_model_from_numpy(coefficients, intercept: float,
                         params: Optional[dict] = None
                         ) -> GeneralizedLinearRegressionModel:
    """A ``GeneralizedLinearRegressionModel`` from host coefficients and
    the JAX model's ``_params`` (family, link, the column names)."""
    return GeneralizedLinearRegressionModel(np.asarray(coefficients),
                                            float(intercept), params)


_TREE_MODELS = {c.__name__: c for c in (
    _tree.DecisionTreeRegressionModel, _tree.RandomForestRegressionModel,
    _tree.DecisionTreeClassificationModel,
    _tree.RandomForestClassificationModel, _tree.GBTRegressionModel,
    _tree.GBTClassificationModel)}


def tree_model_from_numpy(kind: str, trees, num_features: int,
                          max_depth: int, params: Optional[dict] = None, *,
                          num_classes: Optional[int] = None,
                          f0: Optional[float] = None,
                          step_size: Optional[float] = None):
    """The port's tree model named ``kind`` (the JAX class name, such as
    ``"RandomForestClassificationModel"``) from the ``TreeArrays`` fields
    of one tree or a stacked ensemble (``feature``, ``threshold``,
    ``is_leaf``, ``value``, ``gain``; a tuple, a ``TreeArrays`` of either
    package or any object with those attributes, leading axis the trees),
    the classifiers' ``num_classes`` and the GBTs' ``f0`` and
    ``step_size``."""
    cls = _TREE_MODELS[kind]
    fields = _tree.TreeArrays._fields
    arrays = ([np.asarray(getattr(trees, f)) for f in fields]
              if hasattr(trees, "feature")
              else [np.asarray(t) for t in trees])
    if arrays[0].ndim == 1:            # one tree: the stacked (1, N) form
        arrays = [a[None] for a in arrays]
    if "Classification" in kind and "GBT" not in kind:
        return cls(*arrays, num_features, max_depth, num_classes, params)
    if "GBT" in kind:
        return cls(*arrays, num_features, max_depth, f0, step_size, params)
    return cls(*arrays, num_features, max_depth, params)


def kmeans_model_from_numpy(centers, features_col: str = "features",
                            prediction_col: str = "prediction"
                            ) -> KMeansModel:
    """A ``KMeansModel`` from a JAX model's (k, d) ``centers``."""
    return KMeansModel(np.asarray(centers), features_col, prediction_col)


def gmm_model_from_numpy(weights, means, covs,
                         params: Optional[dict] = None
                         ) -> GaussianMixtureModel:
    """A ``GaussianMixtureModel`` from a JAX model's ``weights`` (k,),
    ``means`` (k, d), ``covs`` (k, d, d) and ``_params``."""
    return GaussianMixtureModel(np.asarray(weights), np.asarray(means),
                                np.asarray(covs), params)


# The fitted models of the feature layer (``Bucketizer`` is what
# QuantileDiscretizer fits).
FEATURE_MODELS = ("StandardScalerModel", "MinMaxScalerModel",
                  "MaxAbsScalerModel", "RobustScalerModel",
                  "StringIndexerModel", "OneHotEncoderModel", "Bucketizer",
                  "ImputerModel", "PCAModel", "VectorIndexerModel",
                  "ChiSqSelectorModel", "VarianceThresholdSelectorModel",
                  "UnivariateFeatureSelectorModel", "RFormulaModel")


def _host_value(v):
    if hasattr(v, "__array__") and not isinstance(v, (list, tuple, dict)):
        return np.array(v)
    return copy.deepcopy(v)


def feature_model_to_numpy(model) -> dict:
    """A fitted feature model of either package as ``{"class": name,
    attribute: value}`` over its ``_persist_attrs`` (the two packages
    share them): scaler statistics, StringIndexer labels, OneHotEncoder
    sizes, Bucketizer splits, Imputer surrogates, PCA components and
    ratios, VectorIndexer category maps, selected feature indices and
    RFormula's resolved columns, arrays as numpy."""
    name = type(model).__name__
    if name not in FEATURE_MODELS:
        raise TypeError(f"not a fitted feature model: {name}")
    return {"class": name, **{k: _host_value(getattr(model, k))
                              for k in model._persist_attrs}}


def feature_model_from_numpy(state: dict):
    """The port's feature model of :func:`feature_model_to_numpy`'s dict
    (built as ``load_stage`` builds a stage: its persisted attributes set,
    its derived state rebuilt)."""
    from .models import feature as _feature

    if state.get("class") not in FEATURE_MODELS:
        raise TypeError(f"not a fitted feature model: {state.get('class')}")
    cls = getattr(_feature, state["class"])
    obj = cls.__new__(cls)
    for k in cls._persist_attrs:
        setattr(obj, k, _host_value(state[k]))
    post = getattr(obj, "_post_load", None)
    if post is not None:
        post()
    return obj


def als_model_from_numpy(user_factors, item_factors, user_ids, item_ids,
                         params: Optional[dict] = None, loss_history=None,
                         device=None):
    """The port's ``ALSModel`` from a JAX model's factor matrices and id
    lists (``user_factors_arr``, ``item_factors_arr``, ``user_ids``,
    ``item_ids``), computing on ``device``, by default the one
    ``config.resolve_device`` gives at each call (the active session's)."""
    from .models.recommendation import ALSModel

    return ALSModel(np.asarray(user_factors), np.asarray(item_factors),
                    list(user_ids), list(item_ids), params, loss_history,
                    device=device)


def mlp_model_from_numpy(layers, weights, params: Optional[dict] = None,
                         loss_history=None):
    """The port's ``MultilayerPerceptronClassificationModel`` from a JAX
    model's layer sizes and [(W, b), ...] weights as numpy arrays."""
    from .models.mlp import MultilayerPerceptronClassificationModel

    return MultilayerPerceptronClassificationModel(
        list(layers), [(np.asarray(W), np.asarray(b)) for W, b in weights],
        params, loss_history)


def count_vectorizer_model_from_numpy(vocabulary, min_tf: float = 1.0,
                                      binary: bool = False,
                                      input_col: str = None,
                                      output_col: str = None):
    """The port's ``CountVectorizerModel`` from a JAX model's vocabulary
    and transform settings."""
    from .models.text import CountVectorizerModel

    return CountVectorizerModel([str(w) for w in vocabulary], min_tf,
                                binary, input_col, output_col)


def idf_model_from_numpy(idf, input_col: str = None,
                         output_col: str = None):
    """The port's ``IDFModel`` from a JAX model's weights as numpy."""
    from .models.text import IDFModel

    return IDFModel(np.asarray(idf), input_col, output_col)
