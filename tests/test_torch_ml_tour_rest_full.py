"""Phase 14(b)-(c) of ``chip_smoke.py`` run on the CPU at a small size:
the fits of ``rest_fits`` on seeded inputs (XOR and survival rows, the
DQ-clean table for isotonic, baskets, sessions, documents, LSH points,
binary rows, LDA counts) in float32, then the float64 run of FM, AFT,
Word2Vec and LDA with the float32 run's draws (``float32_draws``), held by
the script's own gates (``check_rest_card``) and its numpy references
(``rest_reference_checks``: numpy isotonic, brute-force itemsets and
sequential patterns, LSH join, MinHash; plain torch float64 LSH hashes
and neighbors, here on the CPU); each fit
bit-identical over two runs; Word2Vec's negatives against the script's
numpy threefry draw. A fault planted in one card result makes its gate
raise. The launch counts are the card's and stay 0 here, so they are
filled in as the card would count them.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.models import word2vec
from sparkdq4ml_tpu_torch.ops.cells import list_column
from sparkdq4ml_tpu_torch.sql import default_catalog
from sparkdq4ml_tpu_torch.utils import prng

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"W2V_DOCS": 1500, "FP_BASKETS": 2000, "PS_SESSIONS": 500,
         "LSH_JOIN_ROWS": 1500, "LSH_HASH_ROWS": 4000, "MINHASH_ROWS": 400,
         "LDA_DOCS": 600, "LDA_TERMS": 200, "ANN_QUERIES": 3}
ROWS = 6000


@pytest.fixture(scope="module")
def runs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for k, v in SMALL.items():
        setattr(smoke, k, v)
    data = smoke.rest_data(ROWS)
    guest, price = smoke.full_table(ROWS)
    fits = smoke.rest_fits(data)
    out = {}
    for name in ("float32", "float64"):
        with float_policy(getattr(torch, name)), smoke.float32_draws():
            spark, clean = smoke.clean_table("cpu", guest, price)
            frames = smoke.rest_frames(data, clean, "cpu")
            out[name] = {fit: fn(frames) for fit, fn in fits
                         if name == "float32"
                         or fit in smoke.REST_CARD_REFERENCE}
            if name == "float32":
                host = clean.to_pydict()
                out["clean"] = (host["guest"], host["price"])
                out["again"] = {fit: fn(frames) for fit, fn in fits
                                if fit in ("word2vec", "lsh_join",
                                           "lda_online")}
            spark.stop()
    default_catalog().clear()
    return smoke, data, out


def launches_as_on_the_card(smoke, card):
    steps = len(card["word2vec"]["loss"])
    counts = {name: {"sorted_segment_sum": 1, "dense_segment_sum": 0}
              for name, _ in smoke.rest_fits({})}
    counts["word2vec"]["sorted_segment_sum"] = 2 * steps + 1
    return counts, steps


def test_phase14_gates_pass_on_the_cpu(runs):
    smoke, data, out = runs
    card, ref = out["float32"], out["float64"]
    for name, again in out["again"].items():
        assert smoke.same_results(card[name], again) == [], name
    launches, steps = launches_as_on_the_card(smoke, card)
    gates = smoke.check_rest_card(card, ref, launches, data, steps)
    assert gates["fm accuracy"] <= smoke.FM_ACCURACY_TOL
    notes = smoke.rest_reference_checks(card, data, out["clean"], "cpu")
    assert notes["fpgrowth"]["itemsets"] > 50
    assert notes["prefixspan"]["patterns"] > 20
    assert notes["lsh_join"]["pairs"] > 0
    assert notes["isotonic"]["boundaries"] > 2
    cdf = smoke.w2v_cdf(list_column(data["docs"]))
    assert smoke.check_negatives(cdf, 1, steps, 4096,
                                 device="cpu")[-1] == steps - 1


@pytest.mark.parametrize("fault", ["isotonic", "fpgrowth", "lsh_join",
                                   "minhash", "lda_em", "aft", "word2vec"])
def test_phase14_gates_catch_a_planted_fault(runs, fault):
    smoke, data, out = runs
    card = {k: dict(v) for k, v in out["float32"].items()}
    launches, steps = launches_as_on_the_card(smoke, card)
    if fault == "isotonic":
        card[fault]["predictions"] = card[fault]["predictions"] + 1e-6
    elif fault == "fpgrowth":
        card[fault]["counts"] = card[fault]["counts"] + (
            np.arange(card[fault]["counts"].size) == 3)
    elif fault == "lsh_join":
        card[fault]["idA"] = card[fault]["idA"][1:]
        card[fault]["idB"] = card[fault]["idB"][1:]
    elif fault == "minhash":
        card[fault]["hashes"] = card[fault]["hashes"] + 1
    elif fault == "lda_em":
        card[fault]["topics"] = card[fault]["topics"] * 1.001
    elif fault == "aft":
        card[fault]["scale"] = card[fault]["scale"] + 2e-3
    else:
        launches["word2vec"]["sorted_segment_sum"] -= 1
    with pytest.raises(AssertionError, match="phase 14"):
        smoke.check_rest_card(card, out["float64"], launches, data, steps)
        smoke.rest_reference_checks(card, data, out["clean"], "cpu")


def test_float32_draws_are_the_float32_runs():
    """The float64 reference draws the float32 run's numbers: JAX's
    normal, gamma and randint as float32 and int32 draws, widened."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    key = prng.PRNGKey(4)
    n32 = prng.normal(key, (50,), torch.float32)
    g32 = prng.gamma(key, 100.0, (3, 4), torch.float32)
    r32 = prng.randint(key, (9,), 0, 77, torch.int32)
    cdf = torch.linspace(0.1, 1.0, 10, dtype=torch.float64)
    neg32 = word2vec.step_negatives(cdf.float(), 2, 0, 3, 8, 5,
                                    torch.float32)
    with smoke.float32_draws():
        assert torch.equal(prng.normal(key, (50,), torch.float64),
                           n32.double())
        assert torch.equal(prng.gamma(key, 100.0, (3, 4), torch.float64),
                           g32.double())
        assert torch.equal(prng.randint(key, (9,), 0, 77, torch.int64),
                           r32.long())
        assert torch.equal(word2vec.step_negatives(
            cdf, 2, 0, 3, 8, 5, torch.float64), neg32)
    assert not torch.equal(prng.normal(key, (50,), torch.float64),
                           n32.double())
