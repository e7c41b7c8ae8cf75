"""Helpers of the feature-layer and ``spark.ml.stat`` parity tests
(``tests/test_torch_feature*.py``, ``tests/test_torch_ml_stat.py``): one
stage of each package built from the same arguments, run on frames of the
same seeded numpy columns, their outputs and fitted state compared.

Float policies: ``float64`` runs the JAX side with x64 on and the port at
one intra-op thread (``torch_repro``); ``float32`` runs the JAX side with
x64 off, as on a TPU. ``pol.rtol``/``pol.atol`` are each test file's
tolerance for a float that a sum or a transcendental function made;
counts, labels, indices, category maps, selections and splits of
integer-valued data are held exactly.
"""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_repro import one_intra_op_thread

from sparkdq4ml_tpu import models as jm
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu_torch import models as tm
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame


def policies(rtol64: float, atol64: float, rtol32: float, atol32: float):
    return {"float64": SimpleNamespace(name="float64", rtol=rtol64,
                                       atol=atol64),
            "float32": SimpleNamespace(name="float32", rtol=rtol32,
                                       atol=atol32)}


@contextlib.contextmanager
def under(pol):
    """Both packages under ``pol``'s float policy (the float64 one at one
    intra-op thread)."""
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    threads = (one_intra_op_thread() if pol.name == "float64"
               else contextlib.nullcontext())
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)), threads:
            yield pol
    finally:
        jax_config.default_float_dtype = old


def policy_fixture(table: dict):
    @pytest.fixture(params=sorted(table))
    def policy(request):
        with under(table[request.param]) as pol:
            yield pol
    return policy


def frames(columns: dict, mask=None):
    """(JAX frame, port frame on the CPU) of the same numpy columns."""
    cols = {k: (np.asarray(v, object) if isinstance(v, list) and any(
        isinstance(x, str) for x in v) else np.asarray(v))
        for k, v in columns.items()}
    m = None if mask is None else np.asarray(mask, bool)
    return (JFrame(dict(cols), mask=None if m is None else jnp.asarray(m)),
            TFrame(dict(cols), mask=m, device="cpu"))


def both(name: str, *args, **kwargs):
    """(JAX stage, port stage) of class ``name`` from the same arguments."""
    return getattr(jm, name)(*args, **kwargs), \
        getattr(tm, name)(*args, **kwargs)


def host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    a = np.asarray(v) if not isinstance(v, np.ndarray) else v
    if a.dtype == object and a.size and isinstance(a.flat[0], np.ndarray):
        return np.stack(list(a))
    return np.asarray(v) if not isinstance(v, np.ndarray) else v


def same_values(want, got, pol, what: str = "", exact: bool = False):
    """``got`` (the port's) against ``want`` (the JAX package's): object
    and integer arrays exactly, floats within the policy's tolerance
    (``exact``: bit for bit), NaN where NaN is."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), what
        for k in want:
            same_values(want[k], got[k], pol, f"{what}[{k}]", exact)
        return
    if isinstance(want, (list, tuple)) and not (
            want and isinstance(want[0], (int, float, np.number))
            and not isinstance(want[0], bool)):
        assert isinstance(got, (list, tuple)) and len(want) == len(got), \
            (what, want, got)
        for i, (a, b) in enumerate(zip(want, got)):
            same_values(a, b, pol, f"{what}[{i}]", exact)
        return
    w, g = host(want), host(got)
    if w.dtype == object or g.dtype == object or w.dtype.kind in "USb" \
            or w.dtype.kind in "iu" and g.dtype.kind in "iu":
        assert w.shape == g.shape, (what, w.shape, g.shape)
        assert w.tolist() == g.tolist(), (what, w, g)
        return
    assert w.shape == g.shape, (what, w.shape, g.shape)
    w64, g64 = w.astype(np.float64), g.astype(np.float64)
    if exact:
        np.testing.assert_array_equal(g64, w64, err_msg=what)
    else:
        np.testing.assert_allclose(g64, w64, rtol=pol.rtol, atol=pol.atol,
                                   err_msg=what)


def same_frames(jout, tout, pol, exact=()):
    """Two frames: the same columns, valid rows and values (``exact``
    columns bit for bit)."""
    assert jout.columns == tout.columns
    assert jout.count() == tout.count()
    a, b = jout.to_pydict(), tout.to_pydict()
    for k in a:
        same_values(a[k], b[k], pol, k, exact=k in exact)


def transform_both(jstage, tstage, jf, tf, pol, exact=()):
    """The two stages' transforms of the two frames compared."""
    same_frames(jstage.transform(jf), tstage.transform(tf), pol, exact)


def same_state(jmodel, tmodel, pol, exact: bool = False):
    """Every persisted attribute of two fitted models."""
    assert type(jmodel).__name__ == type(tmodel).__name__
    assert tmodel._persist_attrs == jmodel._persist_attrs
    for k in jmodel._persist_attrs:
        a, b = getattr(jmodel, k), getattr(tmodel, k)
        if a is None or isinstance(a, (str, bool)):
            assert a == b, (k, a, b)
        elif isinstance(a, (int, float)) and not isinstance(a, bool):
            same_values(np.asarray(a, np.float64), np.asarray(b, np.float64),
                        pol, k, exact)
        else:
            same_values(a, b, pol, k, exact)


def fit_both(name: str, columns: dict, *args, mask=None, **kwargs):
    """Fit class ``name`` of both packages on the same columns: (JAX
    model, port model, JAX frame, port frame)."""
    jf, tf = frames(columns, mask)
    je, te = both(name, *args, **kwargs)
    return je.fit(jf), te.fit(tf), jf, tf


def raises_both(exc, match, fj, ft):
    """Both packages raise ``exc`` matching ``match``."""
    with pytest.raises(exc, match=match):
        fj()
    with pytest.raises(exc, match=match):
        ft()


def round_trip(stage, path) -> object:
    """``stage`` saved by its package and loaded by the other one's
    ``load_stage`` (the two share one on-disk format)."""
    from sparkdq4ml_tpu.models import base as jbase
    from sparkdq4ml_tpu_torch.models import base as tbase

    stage.save(str(path))
    other = jbase if type(stage).__module__.startswith(
        "sparkdq4ml_tpu_torch") else tbase
    return other.load_stage(str(path))
