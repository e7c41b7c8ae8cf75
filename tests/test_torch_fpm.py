"""``FPGrowth`` and ``PrefixSpan`` of the port (``models/fpm.py``) held
against the JAX package on the CPU, on the cases of ``tests/test_fpm.py``
and ``tests/test_prefixspan.py``: the itemsets, their counts and their
order, every rule's antecedent, consequent, confidence, lift and support,
``transform`` (a None row included), masked rows, duplicate items,
thresholds, pattern-length caps, the Spark guide's fixture, random
corpora, an empty frame, every ``ValueError`` and save/load both ways;
then ``chip_smoke.py``'s brute-force numpy counts (phase 14(c)) against
the port on seeded corpora.

Both are host algorithms of the same code on the same lists, so every
output is held exactly, in order, under both float policies (the float
columns of the rules are float64 computations on the host).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.frame.frame import list_column as jlist
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import fpm as jfpm
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import fpm as tfpm
from sparkdq4ml_tpu_torch.ops.cells import list_column as tlist

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASKETS = [["bread", "milk"],
           ["bread", "diaper", "beer", "eggs"],
           ["milk", "diaper", "beer", "cola"],
           ["bread", "milk", "diaper", "beer"],
           ["bread", "milk", "diaper", "cola"]]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(params=["float32", "float64"])
def policy(request):
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, request.param)
    try:
        with jax.enable_x64(request.param == "float64"), \
                float_policy(getattr(torch, request.param)):
            yield request.param
    finally:
        jax_config.default_float_dtype = old


def frames(col, values, mask=None):
    return (JFrame({col: jlist(values)}, mask=mask),
            TFrame({col: tlist(values)}, mask=mask, device="cpu"))


def same_columns(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        x, y = list(a[k]), list(b[k])
        assert len(x) == len(y), k
        for u, v in zip(x, y):
            if isinstance(u, (list, tuple, np.ndarray)):
                assert [list(i) if isinstance(i, (list, tuple, np.ndarray))
                        else i for i in u] == \
                    [list(i) if isinstance(i, (list, tuple, np.ndarray))
                     else i for i in v], k
            elif isinstance(u, float) and np.isnan(u):
                assert np.isnan(v), k
            else:
                assert u == v, k


def random_baskets(seed, n=30, universe="abcdef"):
    rng = np.random.default_rng(seed)
    return [list(rng.choice(list(universe), size=rng.integers(1, 5)))
            for _ in range(n)]


def zipf_baskets(seed, n, items=30):
    """Baskets of 2-6 Zipf-drawn items, duplicates within and across
    baskets (phase 14's construction at a small size)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, items + 1)
    names = np.array([f"i{j:02d}" for j in range(items)], object)
    return [list(rng.choice(names, size=k, p=p / p.sum()))
            for k in rng.integers(2, 7, n)]


@pytest.mark.parametrize("baskets,support,confidence", [
    (BASKETS, 0.4, 0.5), (BASKETS, 0.2, 0.8), (BASKETS, 1.0, 0.0),
    (random_baskets(3), 0.2, 0.5), (random_baskets(4), 0.6, 0.3),
    (random_baskets(5, 60, "abcdefgh"), 0.1, 0.6),
    ([["a", "a", "b"], ["b", "a"], ["c"]], 0.3, 0.5),
    (zipf_baskets(6, 2000), 0.01, 0.5), (zipf_baskets(7, 800), 0.03, 0.2),
])
def test_fpgrowth_matches_the_reference(policy, baskets, support,
                                        confidence):
    j, t = frames("items", baskets)
    a = jfpm.FPGrowth(min_support=support, min_confidence=confidence).fit(j)
    b = tfpm.FPGrowth(min_support=support, min_confidence=confidence).fit(t)
    assert b.itemsets == a.itemsets
    assert b.num_transactions == a.num_transactions
    same_columns(a.association_rules.to_pydict(),
                 b.associationRules.to_pydict())
    same_columns(a.freq_itemsets.to_pydict(), b.freqItemsets.to_pydict())
    queries = [["beer"], ["bread", "milk"], None, ["a"], ["b", "c"], []]
    ja, tb = frames("items", queries)
    same_columns(a.transform(ja).to_pydict(), b.transform(tb).to_pydict())


def test_fpgrowth_masked_rows_and_checks():
    txns = BASKETS + [["poison", "bread"]] * 3 + [None, []]
    keep = np.asarray([True] * 5 + [False] * 3 + [True, True])
    j, t = frames("items", txns, keep)
    a = jfpm.FPGrowth(min_support=0.4).fit(j)
    b = tfpm.FPGrowth(min_support=0.4).fit(t)
    assert b.itemsets == a.itemsets and b.num_transactions == 5
    assert "poison" not in {i for s, _ in b.itemsets for i in s}
    for M in (jfpm, tfpm):
        with pytest.raises(ValueError, match="min_support"):
            M.FPGrowth(min_support=0.0)
        with pytest.raises(ValueError, match="min_confidence"):
            M.FPGrowth(min_confidence=1.5)
        with pytest.raises(ValueError, match="min_support"):
            M.FPGrowth().setMinSupport(2.0)
    with pytest.raises(ValueError, match="no valid transactions"):
        tfpm.FPGrowth().fit(frames("items", [[], None])[1])
    with pytest.raises(ValueError, match="item lists"):
        tfpm.FPGrowth().fit(TFrame({"items": np.arange(3.0)}, device="cpu"))


def test_fpgrowth_model_round_trips_both_ways(tmp_path):
    with float_policy(torch.float64):        # the suite's JAX policy
        _round_trip(tmp_path)


def _round_trip(tmp_path):
    j, t = frames("items", BASKETS)
    a = jfpm.FPGrowth(min_support=0.4, min_confidence=0.5).fit(j)
    a.save(str(tmp_path / "jax"))
    b = tbase.load_stage(str(tmp_path / "jax"))
    assert isinstance(b, tfpm.FPGrowthModel) and b.itemsets == a.itemsets
    same_columns(a.association_rules.to_pydict(),
                 b.association_rules.to_pydict())
    b.save(str(tmp_path / "torch"))
    c = jbase.load_stage(str(tmp_path / "torch"))
    assert c.itemsets == a.itemsets


def mined(M, frame, **kw):
    return M.PrefixSpan(**kw).find_frequent_sequential_patterns(
        frame).to_pydict()


def random_sequences(seed, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append([sorted(set(rng.choice(list("abcd"),
                                          size=rng.integers(1, 4))))
                    for _ in range(rng.integers(1, 5))])
    return out


@pytest.mark.parametrize("seqs,kw", [
    ([[[1, 2], [3]], [[1], [3, 2], [1, 2]], [[1, 2], [5]], [[6]]],
     dict(min_support=0.5, max_pattern_length=5)),
    ([[["a", "b"]], [["a", "b"]], [["a"], ["b"]], [["a"], ["b"]]],
     dict(min_support=0.5)),
    ([[["a"], ["b"], ["c"]]] * 2, dict(min_support=1.0,
                                       max_pattern_length=2)),
    ([[["a"], ["a"]], [["a"], ["a"]]], dict(min_support=1.0)),
    ([[["a"], ["a"], ["a"]], [["b"]]], dict(min_support=0.5)),
    ([[["a", "a", "b"], ["b"]], [["b", "a"]]], dict(min_support=0.5)),
    *[(random_sequences(s), dict(min_support=float(sup),
                                 max_pattern_length=int(ml)))
      for s, sup, ml in ((0, 0.25, 3), (1, 0.5, 2), (2, 0.25, 4),
                         (3, 0.5, 3))],
])
def test_prefixspan_matches_the_reference(policy, seqs, kw):
    j, t = frames("sequence", seqs)
    same_columns(mined(jfpm, j, **kw), mined(tfpm, t, **kw))


def test_prefixspan_mask_surface_and_checks():
    seqs = [[["a"], ["b"]], [["a"], ["b"]], [["z"]], [["z"]], None]
    keep = np.asarray([True, True, False, False, True])
    j, t = frames("sequence", seqs, keep)
    same_columns(mined(jfpm, j, min_support=1.0),
                 mined(tfpm, t, min_support=1.0))
    empty = mined(tfpm, frames("sequence", [None], np.asarray([False]))[1])
    assert len(empty["freq"]) == 0 and len(empty["sequence"]) == 0
    ps = (tfpm.PrefixSpan().setMinSupport(0.4).setMaxPatternLength(3)
          .setSequenceCol("s").setMaxLocalProjDBSize(1000))
    assert ps.min_support == 0.4 and ps.max_pattern_length == 3
    f = TFrame({"s": tlist([[["p"], ["q"]], [["p"], ["q"]]])}, device="cpu")
    d = ps.findFrequentSequentialPatterns(f).to_pydict()
    assert [["p"], ["q"]] in [list(map(list, s)) for s in d["sequence"]]
    for M in (jfpm, tfpm):
        with pytest.raises(ValueError, match="min_support"):
            M.PrefixSpan(min_support=1.5)
        with pytest.raises(ValueError, match="max_pattern_length"):
            M.PrefixSpan(max_pattern_length=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_chip_smoke_brute_force_counts_match_the_port(seed):
    """Phase 14(c)'s numpy references: every frequent itemset and
    sequential pattern with its count, grown one item at a time."""
    smoke = load_smoke()
    rng = np.random.default_rng(seed)
    items = np.array([f"i{j:02d}" for j in range(12)], object)
    baskets = smoke._ragged(rng, rng.integers(2, 7, 400), items,
                            smoke._zipf(12))
    m = tfpm.FPGrowth(min_support=0.05).fit(frames("items", baskets)[1])
    assert smoke.numpy_itemsets(baskets, 0.05) == {
        " ".join(s): c for s, c in m.itemsets}
    pages = np.array([f"p{j}" for j in range(6)], object)
    sessions = [[sorted(set(x)) for x in np.split(
        rng.choice(pages, size=2 * n), 2)] + [[str(rng.choice(pages))]]
        for n in rng.integers(1, 3, 150)]
    d = mined(tfpm, frames("sequence", sessions)[1], min_support=0.1,
              max_pattern_length=4)
    got = {"|".join(" ".join(i) for i in s): int(f)
           for s, f in zip(d["sequence"], d["freq"])}
    assert smoke.numpy_sequences(sessions, 0.1, max_len=4) == got
