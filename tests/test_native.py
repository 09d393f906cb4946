"""Native components: graphgen binary + fastload scanner.

Equivalent of the reference's native component coverage (its C++ ising
generator feeding the Python loaders; reference ising/ising.cpp). Skipped
when the native tools haven't been built (`make -C native`).
"""

import os
import subprocess

import numpy as np
import pytest

from numbskull_jax import dataloading as dl
from numbskull_jax import types as T

NATIVE = os.path.join(os.path.dirname(__file__), "..", "native")
GRAPHGEN = os.path.join(NATIVE, "graphgen")
FASTLOAD = os.path.join(NATIVE, "libfastload.so")

needs_graphgen = pytest.mark.skipif(not os.path.exists(GRAPHGEN),
                                    reason="run `make -C native` first")


@needs_graphgen
def test_graphgen_ising_loads(tmp_path):
    out = str(tmp_path / "ig")
    subprocess.run([GRAPHGEN, "ising", out, "6", "7", "0.25"], check=True)
    meta, w, v, f, fm, _, _ = dl.load_factor_graph_files(out)
    assert int(meta["variables"]) == 42
    assert int(meta["factors"]) == 6 * 6 + 7 * 5  # grid edge count
    assert (f["factorFunction"] == T.FUNC_EQUAL).all()
    assert w["isFixed"][0] and w["initialValue"][0] == 0.25


@needs_graphgen
def test_graphgen_matches_python_writer(tmp_path):
    """graphgen's ising output is byte-identical to the python writer fed
    the same model."""
    from numbskull_jax.models import ising_grid

    out = str(tmp_path / "native")
    subprocess.run([GRAPHGEN, "ising", out, "5", "5", "0.1"], check=True)
    w, v, f, fm, dm, e = ising_grid(5, 5, weight=0.1)
    v["initialValue"] = 0  # graphgen writes zero initial values
    pyout = str(tmp_path / "python")
    dl.write_factor_graph_files(pyout, w, v, f, fm)
    for name in ["graph.weights", "graph.variables", "graph.factors",
                 "graph.meta"]:
        a = open(os.path.join(out, name), "rb").read()
        b = open(os.path.join(pyout, name), "rb").read()
        assert a == b, name


@needs_graphgen
def test_graphgen_coin_learnable(tmp_path):
    """Generated coin evidence supports weight recovery end to end."""
    import jax

    from numbskull_jax.compile import compile_graph
    from numbskull_jax.ops import GibbsEngine, LearnParams

    out = str(tmp_path / "coin")
    subprocess.run([GRAPHGEN, "coin", out, "2000", "0.8", "-0.5", "0.4",
                    "11"], check=True)
    _, w, v, f, fm, _, _ = dl.load_factor_graph_files(out)
    cg = compile_graph(w, v, f, fm)
    eng = GibbsEngine(cg)
    st = eng.init_state()
    st = eng.learn(st, jax.random.PRNGKey(0), epochs=150, stepsize=0.1,
                   decay=0.99, burn=10,
                   lp=LearnParams(regularization=2, reg_param=1e-4))
    got = np.asarray(st.weight_value)
    assert got[0] == pytest.approx(0.8, abs=0.15)
    assert got[1] == pytest.approx(-0.5, abs=0.15)
    assert got[2] == pytest.approx(0.4, abs=0.15)


@pytest.mark.skipif(not os.path.exists(FASTLOAD),
                    reason="run `make -C native` first")
def test_fastload_matches_numpy_parser(tmp_path):
    """Native scanner and numpy run-parser produce identical arrays."""
    rng = np.random.default_rng(2)
    n = 53
    arities = rng.integers(1, 6, n)
    w = T.new_weights(3)
    v = T.new_variables(30)
    v["cardinality"] = 2
    f = T.new_factors(n)
    f["factorFunction"] = rng.choice([1, 2, 3, 4], n)
    f["weightId"] = rng.integers(0, 3, n)
    f["featureValue"] = rng.normal(size=n)
    f["arity"] = arities
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(arities)[:-1]))
    E = int(arities.sum())
    fm = T.new_fmap(E)
    fm["vid"] = rng.integers(0, 30, E)
    out = str(tmp_path / "g")
    dl.write_factor_graph_files(out, w, v, f, fm)

    data = open(os.path.join(out, "graph.factors"), "rb").read()
    # native path
    os.environ["NUMBSKULL_JAX_FASTLOAD"] = FASTLOAD
    dl._FASTLOAD = None
    f1, fm1 = dl.load_factors(data, n, E)
    assert dl._FASTLOAD not in (None, False)
    # numpy path
    dl._FASTLOAD = False
    f2, fm2 = dl.load_factors(data, n, E)
    dl._FASTLOAD = None
    assert (f1 == f2).all()
    assert (fm1 == fm2).all()

    # corrupt stream: native scanner reports, not crashes
    os.environ["NUMBSKULL_JAX_FASTLOAD"] = FASTLOAD
    dl._FASTLOAD = None
    with pytest.raises(ValueError):
        dl.load_factors(data[:-8], n, E)
    dl._FASTLOAD = None

COMPILECORE = os.path.join(NATIVE, "libcompilecore.so")
needs_core = pytest.mark.skipif(not os.path.exists(COMPILECORE),
                                reason="run `make -C native` first")

_PLAN_FIELDS = (
    "cv_vid", "cv_card", "cv_isev", "cv_valid", "it_row", "it_ftype",
    "it_wid", "it_fv", "it_dense", "it_d1", "it_d2", "it_valid",
    "it_arity", "it_args_vid", "it_args_eq", "it_args_valid",
    "it_args_card", "it_subst")


@needs_core
def test_compilecore_plans_equal_numpy_oracle():
    """The native compile core emits color plans exactly equal to the
    numpy pipeline on random mixed boolean/categorical graphs with
    duplicate args and skipped factors."""
    import numbskull_jax.compile as C

    assert C._compilecore() is not None
    rng = np.random.default_rng(7)
    for trial in range(3):
        V, F = 150, 220
        v = T.new_variables(V)
        v["isEvidence"] = rng.integers(0, 2, V)
        v["dataType"] = rng.integers(0, 2, V)
        v["cardinality"] = np.where(v["dataType"] == 0, 2,
                                    rng.integers(2, 5, V))
        ar = rng.integers(1, 5, F)
        f = T.new_factors(F)
        f["factorFunction"] = rng.choice([0, 2, 4, 13], F)
        f["weightId"] = rng.integers(0, 10, F)
        f["featureValue"] = rng.random(F)
        f["arity"] = ar
        f["ftv_offset"] = np.concatenate(([0], np.cumsum(ar)[:-1]))
        E = int(ar.sum())
        fm = T.new_fmap(E)
        fm["vid"] = rng.integers(0, V, E)
        fm["dense_equal_to"] = rng.integers(0, 4, E)
        skip = rng.choice(F, size=9, replace=False).astype(np.int64)
        edges = C.conflict_edges(v, f, fm, skip)
        color = C.reduce_colors(
            C.color_variables(V, edges, seed=trial), edges, seed=trial)
        nc = int(color.max()) + 1
        vc = v["cardinality"].astype(np.int64)
        pn = C._plans_numpy(v, f, fm, skip, color, nc, vc, 128, 8)
        pc = C._plans_native(v, f, fm, skip, color, nc, vc, 128, 8)
        assert pc is not None
        assert len(pn) == len(pc)
        for pa, pb in zip(pn, pc):
            assert pa.amax == pb.amax and pa.kmax == pb.kmax
            for fld in _PLAN_FIELDS:
                va = np.asarray(getattr(pa, fld))
                vb = np.asarray(getattr(pb, fld))
                assert va.shape == vb.shape, fld
                assert (va == vb).all(), fld


@needs_core
def test_compilecore_multibucket_fill_equal_numpy_oracle(monkeypatch):
    """The bucketed fill path (compile_fill3 with B > 1 staging
    buckets) is byte-identical to the numpy oracle; in production the
    bucket split only engages at ~96 MB arenas, so shrink the bucket
    size to a few hundred bytes to force many buckets on a small
    graph."""
    import numbskull_jax.compile as C

    core = C._compilecore()
    assert core is not None
    if not hasattr(core, "compile_fill3"):
        pytest.skip("compile_fill3 not in this core build")
    monkeypatch.setenv("NSX_FILL_BUCKET_BYTES", "384")
    rng = np.random.default_rng(11)
    V, F = 120, 260
    v = T.new_variables(V)
    v["isEvidence"] = rng.integers(0, 2, V)
    v["dataType"] = rng.integers(0, 2, V)
    v["cardinality"] = np.where(v["dataType"] == 0, 2,
                                rng.integers(2, 6, V))
    ar = rng.integers(1, 6, F)   # odd arities exercise record padding
    f = T.new_factors(F)
    f["factorFunction"] = rng.choice([0, 2, 4, 13], F)
    f["weightId"] = rng.integers(0, 10, F)
    f["featureValue"] = rng.random(F)
    f["arity"] = ar
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(ar)[:-1]))
    E = int(ar.sum())
    fm = T.new_fmap(E)
    fm["vid"] = rng.integers(0, V, E)
    fm["dense_equal_to"] = rng.integers(0, 5, E)
    edges = C.conflict_edges(v, f, fm, None)
    color = C.reduce_colors(
        C.color_variables(V, edges, seed=3), edges, seed=3)
    nc = int(color.max()) + 1
    vc = v["cardinality"].astype(np.int64)
    pn = C._plans_numpy(v, f, fm, None, color, nc, vc, 128, 8)
    pc = C._plans_native(v, f, fm, None, color, nc, vc, 128, 8)
    assert pc is not None and len(pn) == len(pc)
    for pa, pb in zip(pn, pc):
        for fld in _PLAN_FIELDS:
            assert (np.asarray(getattr(pa, fld)) ==
                    np.asarray(getattr(pb, fld))).all(), fld


@needs_core
def test_native_dump_matches_numpy_formatter(tmp_path):
    """dump_rows output parses to the same values as the numpy
    formatter, including negatives and zero-padding."""
    from numbskull_jax.numbskull import _format_cols, _native_dump

    rng = np.random.default_rng(3)
    a = rng.integers(0, 10 ** 6, 500)
    b = rng.integers(0, 9, 500)
    x = rng.normal(size=500) * 3
    p1 = str(tmp_path / "native.txt")
    assert _native_dump(p1, a, b, x, 3)
    blob = _format_cols((a, b, ("fixed", x, 3)))
    g1 = np.loadtxt(p1)
    g2 = np.loadtxt((tmp_path / "np.txt").write_bytes(blob) and
                    str(tmp_path / "np.txt"))
    assert (g1 == g2).all()
    # 2-column (weights) form
    p2 = str(tmp_path / "w.txt")
    assert _native_dump(p2, a[:5], None, x[:5], 6)
    g3 = np.loadtxt(p2)
    assert np.allclose(g3[:, 1], np.round(x[:5], 6))
    # exact half-ulp ties must round half-EVEN in both paths (advisor
    # r2: llround's half-away-from-zero diverged from np.round here)
    ties = np.array([0.0005, 0.0015, 0.0025, -0.0005, -0.0015, 0.5115])
    ids = np.arange(len(ties))
    p3 = str(tmp_path / "tie.txt")
    assert _native_dump(p3, ids, None, ties, 3)
    blob = _format_cols((ids, ("fixed", ties, 3)))
    (tmp_path / "tie_np.txt").write_bytes(blob)
    t1 = np.loadtxt(p3)
    t2 = np.loadtxt(str(tmp_path / "tie_np.txt"))
    assert (t1 == t2).all()
    # spot-check the half-even results themselves
    assert t1[:, 1].tolist() == [0.0, 0.002, 0.002, 0.0, -0.002, 0.511]
