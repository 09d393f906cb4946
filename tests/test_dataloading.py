"""Binary format I/O: fixture parity, round trips, domains."""

import os

import numpy as np

from numbskull_jax import dataloading as dl
from numbskull_jax import types as T

REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "coin18")


def test_load_reference_fixture():
    meta, w, v, f, fm, vmap, dmask = dl.load_factor_graph_files(REF_DIR)
    assert int(meta["weights"]) == 1
    assert int(meta["variables"]) == 18
    assert int(meta["factors"]) == 18
    assert int(meta["edges"]) == 18
    assert not w["isFixed"][0] and w["initialValue"][0] == 0.0
    assert (v["cardinality"] == 2).all()
    # fixture: 9 evidence vars (8 true, 1 false) + 9 query vars,
    # each with one ISTRUE factor
    assert (v["isEvidence"] == [1] * 9 + [0] * 9).all()
    assert set(np.unique(f["factorFunction"])) == {T.FUNC_ISTRUE}
    assert (f["arity"] == 1).all()
    assert (fm["vid"] == np.arange(18)).all()
    assert not dmask.any()


def test_round_trip_bytes(tmp_path):
    meta, w, v, f, fm, _, _ = dl.load_factor_graph_files(REF_DIR)
    out = str(tmp_path / "rt")
    dl.write_factor_graph_files(out, w, v, f, fm)
    for name in ["graph.weights", "graph.variables", "graph.factors"]:
        ref = open(REF_DIR + "/" + name, "rb").read()
        ours = open(out + "/" + name, "rb").read()
        assert ref == ours, name


def test_mixed_arity_runs(tmp_path):
    """Factor stream with alternating arities parses correctly."""
    rng = np.random.default_rng(0)
    n = 37
    arities = rng.integers(1, 5, n)
    V = 10
    w = T.new_weights(2)
    v = T.new_variables(V)
    v["cardinality"] = 2
    f = T.new_factors(n)
    f["factorFunction"] = T.FUNC_OR
    f["weightId"] = rng.integers(0, 2, n)
    f["featureValue"] = rng.random(n)
    f["arity"] = arities
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(arities)[:-1]))
    E = int(arities.sum())
    fm = T.new_fmap(E)
    fm["vid"] = rng.integers(0, V, E)

    out = str(tmp_path / "mixed")
    dl.write_factor_graph_files(out, w, v, f, fm)
    _, w2, v2, f2, fm2, _, _ = dl.load_factor_graph_files(out)
    assert (f2 == f).all()
    assert (fm2 == fm).all()


def test_domains_densification(tmp_path):
    """Explicit domains: vmap values stored, initialValue + equal-to
    densified (reference dataloading.py:159-187, 219-223)."""
    w = T.new_weights(1)
    v = T.new_variables(2)
    v["dataType"] = [1, 0]
    v["cardinality"] = [3, 2]
    v["initialValue"] = [20, 0]     # 20 is the middle domain value
    f = T.new_factors(1)
    f["factorFunction"] = T.FUNC_AND_CAT
    f["arity"] = 2
    f["ftv_offset"] = 0
    fm = T.new_fmap(2)
    fm["vid"] = [0, 1]
    fm["dense_equal_to"] = [30, 0]  # raw domain value 30 -> dense index 2

    out = str(tmp_path / "dom")
    dl.write_factor_graph_files(out, w, v, f, fm,
                                domains={0: np.array([10, 20, 30])})
    _, _, v2, f2, fm2, vmap2, dmask2 = dl.load_factor_graph_files(out)
    assert dmask2[0] and not dmask2[1]
    assert list(vmap2["value"][:3]) == [10, 20, 30]
    assert v2["initialValue"][0] == 1          # densified from 20
    assert fm2["dense_equal_to"][0] == 2       # densified from 30
