"""Estimator / Transformer / Model / Pipeline bases (the MLlib ``ml``
pipeline contracts) and the stage persistence of the port (port of
``sparkdq4ml_tpu/models/base.py``).

Persistence: every stage class declares ``_persist_attrs`` (the attributes
that fully determine it) and registers itself with ``@persistable``;
``save_stage``/``load_stage`` write/read one JSON file per stage (numpy
arrays embedded with a dtype tag), and ``Pipeline``/``PipelineModel`` save
their stages into numbered subdirectories. The on-disk format is the JAX
package's, so a stage or pipeline saved by either package loads in the
other.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from ..config import float_dtype

_STAGE_REGISTRY: dict[str, type] = {}


def host_fetch(x) -> np.ndarray:
    """The counted device-to-host pull of a model accessor (one
    ``frame.host_sync`` a call), host numpy out."""
    from ..utils.profiling import counters

    counters.increment("frame.host_sync")
    if hasattr(x, "cpu"):
        x = x.cpu()
    return np.asarray(x)


def persistable(cls):
    """Class decorator: register for name-based ``load_stage``."""
    _STAGE_REGISTRY[cls.__name__] = cls
    return cls


def _to_jsonable(v):
    if isinstance(v, np.ndarray):
        dt = "object" if v.dtype == object else str(v.dtype)
        return {"__ndarray__": v.tolist(), "dtype": dt}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    return v


def _from_jsonable(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        dt = v["dtype"]
        return np.asarray(v["__ndarray__"],
                          object if dt == "object" else np.dtype(dt))
    if isinstance(v, dict):
        return {k: _from_jsonable(x) for k, x in v.items()}
    return v


def save_stage(stage, path: str) -> None:
    """Persist one stage (transformer, estimator or model) to ``path/``."""
    if hasattr(stage, "_save_to_dir"):      # composite stages
        stage._save_to_dir(path)
        return
    attrs = getattr(stage, "_persist_attrs", None)
    if attrs is None:
        raise TypeError(f"{type(stage).__name__} is not persistable "
                        "(no _persist_attrs)")
    write_json(os.path.join(path, "stage.json"),
               {"class": type(stage).__name__,
                "data": {k: _to_jsonable(getattr(stage, k)) for k in attrs}})


def load_stage(path: str):
    """Load any persisted stage; dispatches on the recorded class name."""
    meta_path = os.path.join(path, "stage.json")
    if not os.path.exists(meta_path):       # composite stage directory
        comp = read_json(os.path.join(path, "metadata.json"))
        cls = _STAGE_REGISTRY.get(comp["class"])
        if cls is None or not hasattr(cls, "_load_from_dir"):
            raise ValueError(f"unknown composite stage {comp['class']!r}")
        return cls._load_from_dir(path, comp)
    meta = read_json(meta_path)
    cls = _STAGE_REGISTRY.get(meta["class"])
    if cls is None:
        raise ValueError(f"unknown stage class {meta['class']!r}; known: "
                         f"{sorted(_STAGE_REGISTRY)}")
    obj = cls.__new__(cls)
    for k, v in meta["data"].items():
        setattr(obj, k, _from_jsonable(v))
    post = getattr(obj, "_post_load", None)
    if post is not None:        # derived state (BisectingKMeansModel)
        post()
    return obj


class _Persist:
    """``save``/``load`` (and MLlib's ``write().overwrite().save``), shared
    by every stage kind."""

    def save(self, path: str) -> None:
        save_stage(self, path)

    def write(self) -> "_Writer":
        return _Writer(self)

    @classmethod
    def load(cls, path: str):
        obj = load_stage(path)
        if not isinstance(obj, cls):
            raise TypeError(f"{path} holds a {type(obj).__name__}, "
                            f"not a {cls.__name__}")
        return obj

    read = load


class _Writer:
    def __init__(self, stage):
        self._stage = stage

    def overwrite(self) -> "_Writer":
        return self

    def save(self, path: str) -> None:
        save_stage(self._stage, path)


def no_mesh(mesh, what: str) -> None:
    """Fits take no mesh in the port: one device."""
    if mesh is not None:
        raise NotImplementedError(f"{what}: fits over a mesh are not "
                                  "ported; the port fits on one device")


def feature_matrix(frame, name: str):
    """A features column as an (n, d) tensor in the policy's float dtype,
    on the frame's device (a 1-D column is one feature)."""
    X = frame._column_values(name).to(float_dtype())
    return X[:, None] if X.ndim == 1 else X


class Transformer(_Persist):
    """Frame -> Frame."""

    def transform(self, frame):  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, frame):
        return self.transform(frame)


class Estimator(_Persist):
    """Frame -> Model."""

    def fit(self, frame):  # pragma: no cover - abstract
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer."""


def _save_stages(obj, stages, path: str) -> None:
    write_json(os.path.join(path, "metadata.json"),
               {"class": type(obj).__name__, "n_stages": len(stages)})
    for i, st in enumerate(stages):
        save_stage(st, os.path.join(path, f"stage_{i:02d}"))


def _load_stages(path: str, meta: dict) -> list:
    return [load_stage(os.path.join(path, f"stage_{i:02d}"))
            for i in range(meta["n_stages"])]


@persistable
class Pipeline(Estimator):
    """Chain of stages; each Estimator stage is fit on the running frame
    and replaced by its Model."""

    def __init__(self, stages: Sequence = ()):
        self._stages = list(stages)

    def _save_to_dir(self, path: str) -> None:
        _save_stages(self, self._stages, path)

    @classmethod
    def _load_from_dir(cls, path: str, meta: dict):
        return cls(_load_stages(path, meta))

    def set_stages(self, stages: Sequence) -> "Pipeline":
        self._stages = list(stages)
        return self

    setStages = set_stages

    def get_stages(self) -> list:
        return list(self._stages)

    getStages = get_stages

    def fit(self, frame) -> "PipelineModel":
        fitted = []
        cur = frame
        for stage in self._stages:
            if isinstance(stage, Estimator):
                stage = stage.fit(cur)
            fitted.append(stage)
            cur = stage.transform(cur)
        return PipelineModel(fitted)


@persistable
class PipelineModel(Model):
    def __init__(self, stages: Sequence):
        self.stages = list(stages)

    def transform(self, frame):
        for stage in self.stages:
            frame = stage.transform(frame)
        return frame

    def _save_to_dir(self, path: str) -> None:
        _save_stages(self, self.stages, path)

    @classmethod
    def _load_from_dir(cls, path: str, meta: dict):
        return cls(_load_stages(path, meta))


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=float)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)
