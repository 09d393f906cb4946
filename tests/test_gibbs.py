"""Gibbs engine correctness: potential parity vs the golden oracle,
marginal convergence vs exact distributions, evidence semantics.

This is substantially stronger than the reference's test strategy (three
assert-free scripts, SURVEY.md §4): potentials are checked exactly, and
marginals against closed-form joints with Monte-Carlo tolerance.
"""

import numpy as np
import pytest

import jax

from numbskull_jax import golden
from numbskull_jax import types as T
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import (
    coin_exact_marginal, coin_model, ising_color_hint, ising_grid, lf_model,
    voting_model,
)
from numbskull_jax.ops import GibbsEngine
from numbskull_jax.ops.gibbs import color_potentials


def _potentials_parity(cg, weights_val, var_value):
    """Engine color_potentials must equal golden potential for every
    (variable, value)."""
    eng = GibbsEngine(cg)
    wv = np.asarray(weights_val, np.float32)
    import jax.numpy as jnp
    for ci, pd in enumerate(eng.plans):
        pot = np.asarray(color_potentials(
            pd, eng.plan_kmax[ci], eng.present[ci],
            jnp.asarray(var_value.astype(np.int32)), jnp.asarray(wv)))
        plan = cg.plans[ci]
        for r in range(plan.n_rows):
            if not plan.cv_valid[r]:
                continue
            vid = int(plan.cv_vid[r])
            for k in range(int(plan.cv_card[r])):
                want = golden.potential(
                    cg_vars, cg_factors, cg_fmap, wv, vid, k, var_value)
                assert pot[r, k] == pytest.approx(want, abs=1e-4), \
                    (ci, vid, k, pot[r, k], want)


def test_potentials_match_golden_random_graph():
    global cg_vars, cg_factors, cg_fmap
    rng = np.random.default_rng(3)
    n_vars, n_factors = 10, 25
    v = T.new_variables(n_vars)
    is_cat = rng.random(n_vars) < 0.3
    v["dataType"] = is_cat.astype(np.int16)
    v["cardinality"] = np.where(is_cat, 3, 2)
    w = T.new_weights(4)
    w["initialValue"] = rng.normal(size=4)
    funcs = [T.FUNC_OR, T.FUNC_AND, T.FUNC_EQUAL, T.FUNC_ISTRUE,
             T.FUNC_LINEAR, T.FUNC_RATIO, T.FUNC_LOGICAL, T.FUNC_OR_CAT,
             T.FUNC_AND_CAT]
    arities = rng.integers(1, 4, n_factors)
    f = T.new_factors(n_factors)
    f["factorFunction"] = rng.choice(funcs, n_factors)
    f["weightId"] = rng.integers(0, 4, n_factors)
    f["featureValue"] = 1.0
    f["arity"] = arities
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(arities)[:-1]))
    E = int(arities.sum())
    fm = T.new_fmap(E)
    fm["vid"] = rng.integers(0, n_vars, E)
    for j in range(E):
        fm["dense_equal_to"][j] = rng.integers(
            0, v["cardinality"][fm["vid"][j]])

    cg_vars, cg_factors, cg_fmap = v, f, fm
    cg = compile_graph(w, v, f, fm)
    var_value = rng.integers(0, 2, n_vars)
    var_value = np.minimum(var_value, v["cardinality"] - 1)
    _potentials_parity(cg, w["initialValue"], var_value)


def _run_marginals(args, epochs=3000, burn=200, seed=0, hint=None,
                   sample_evidence=True):
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm, color_hint=hint)
    eng = GibbsEngine(cg)
    st = eng.init_state()
    st = eng.inference(st, jax.random.PRNGKey(seed), epochs, burn=burn,
                       sample_evidence=sample_evidence)
    return np.asarray(st.count, np.float64) / epochs, cg


def test_coin_marginals_exact():
    a, b, c = 0.4, -0.3, 0.6
    args = coin_model(1, a, b, c, evidence=False,
                      weight_init=(a, b, c), fixed=True)
    marg, _ = _run_marginals(args, epochs=8000, burn=300)
    p = coin_exact_marginal(a, b, c)
    assert marg[0, 1] == pytest.approx(p[2] + p[3], abs=0.03)
    assert marg[1, 1] == pytest.approx(p[1] + p[3], abs=0.03)


def test_small_ising_marginals_exact():
    args = ising_grid(3, 3, weight=0.4)
    w, v, f, fm, dm, e = args
    marg, cg = _run_marginals(args, epochs=6000, burn=300,
                              hint=ising_color_hint(3, 3))
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    assert np.abs(marg[:, 1] - exact[:, 1]).max() < 0.04


def test_voting_marginals_exact():
    """High-arity OR factors against brute-force enumeration."""
    args = voting_model(n_vars=8, n_factors=6, degree=4, weight=0.7,
                        seed=5)
    w, v, f, fm, dm, e = args
    marg, cg = _run_marginals(args, epochs=6000, burn=300)
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    assert np.abs(marg[:, 1] - exact[:, 1]).max() < 0.04


def test_lf_model_marginals():
    """Categorical cardinality-3 vars + DP factors vs enumeration."""
    args = lf_model(0.3, [0.8], copies=2, seed=1)
    w, v, f, fm, dm, e = args
    w["initialValue"] = [0.3, 0.8]  # set to truth; vars free
    v["isEvidence"] = 0
    marg, cg = _run_marginals(args, epochs=8000, burn=300)
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    kmax = marg.shape[1]
    assert np.abs(marg - exact[:, :kmax]).max() < 0.04


def test_evidence_not_sampled():
    """sample_evidence=False: evidence vars stay at initialValue and are
    never tallied (reference inference.py:24, count untouched)."""
    args = coin_model(4, evidence=True, weight_init=(0.5, 0.5, 0.5),
                      fixed=True)
    w, v, f, fm, dm, e = args
    marg, cg = _run_marginals(args, epochs=200, burn=10,
                              sample_evidence=False)
    assert (marg == 0).all()  # all vars are evidence -> nothing tallied


def test_not_owned_never_touched():
    """isEvidence==4 variables are never sampled (reference
    inference.py:21-23)."""
    args = coin_model(2, evidence=False, weight_init=(2.0, 2.0, 0.0),
                      fixed=True)
    w, v, f, fm, dm, e = args
    v["isEvidence"][0] = 4
    v["initialValue"][0] = 0
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    eng = GibbsEngine(cg)
    st = eng.init_state()
    st = eng.inference(st, jax.random.PRNGKey(0), 500, burn=50)
    vv = np.asarray(st.var_value)
    assert vv[0] == 0                      # frozen
    assert np.asarray(st.count)[0].sum() == 0  # not tallied
    # other vars sampled: strong positive weight pushes them to 1
    assert np.asarray(st.count)[2:, 1].mean() > 300


def test_reproducible():
    args = ising_grid(4, 4, weight=0.3)
    m1, _ = _run_marginals(args, epochs=100, burn=10, seed=7)
    m2, _ = _run_marginals(args, epochs=100, burn=10, seed=7)
    assert (m1 == m2).all()


def test_potts_card4_marginals_exact():
    """High-cardinality categorical (Potts) grid through the padded
    fast path vs brute-force enumeration."""
    from numbskull_jax.models import potts_grid

    args = potts_grid(2, 3, card=4, weight=0.5)
    w, v, f, fm, dm, e = args
    marg, cg = _run_marginals(args, epochs=6000, burn=300)
    # brute-force the Potts joint: P(x) ∝ exp(Σ_f w*(1 if equal else -1))
    V, K, wt = len(v), 4, float(w["initialValue"][0])
    pairs = fm["vid"].reshape(-1, 2)
    states = np.stack(np.meshgrid(*([np.arange(K)] * V),
                                  indexing="ij")).reshape(V, -1)
    eq = (states[pairs[:, 0]] == states[pairs[:, 1]])
    logp = wt * np.where(eq, 1.0, -1.0).sum(axis=0)
    p = np.exp(logp - logp.max())
    p /= p.sum()
    exact = np.zeros((V, K))
    for k in range(K):
        exact[:, k] = ((states == k) * p[None, :]).sum(axis=1)
    assert np.abs(marg - exact).max() < 0.04


def test_padded_path_active_and_matches_flat():
    """The padded row-major inference path must activate on ordinary
    graphs and agree with the flat work-item path (same draw key
    structure; potentials equal up to fp summation order)."""
    args = ising_grid(6, 6, weight=0.35)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    fast = GibbsEngine(cg)
    assert fast.padded_meta is not None
    slow = GibbsEngine(cg, padded=False)
    assert slow.padded is None
    key = jax.random.PRNGKey(3)
    epochs = 3000
    s1 = fast.inference(fast.init_state(), key, epochs, burn=200)
    s2 = slow.inference(slow.init_state(), key, epochs, burn=200)
    m1 = np.asarray(s1.count, np.float64) / epochs
    m2 = np.asarray(s2.count, np.float64) / epochs
    assert np.abs(m1 - m2).max() < 0.05


def test_padded_path_falls_back_on_hub_rows():
    """A variable in hundreds of factors exceeds the padded layout's
    per-row slot cap; the engine must fall back to the flat path and
    still sample correctly."""
    from numbskull_jax.ops.gibbs import PADDED_DMAX

    D = PADDED_DMAX + 10
    v = T.new_variables(1)
    v["isEvidence"] = 0
    v["dataType"] = 0
    v["cardinality"] = 2
    w = T.new_weights(1)
    w["isFixed"] = True
    w["initialValue"] = 0.01
    f = T.new_factors(D)
    f["factorFunction"] = T.FUNC_ISTRUE
    f["weightId"] = 0
    f["featureValue"] = 1.0
    f["arity"] = 1
    f["ftv_offset"] = np.arange(D, dtype=np.int64)
    fm = T.new_fmap(D)
    fm["vid"] = 0
    cg = compile_graph(w, v, f, fm)
    eng = GibbsEngine(cg)
    assert eng.padded is None
    st = eng.inference(eng.init_state(), jax.random.PRNGKey(0), 400)
    # potential(1) - potential(0) = D * 0.01 * 2 = 5.4 -> P(1) ~ 0.996
    p1 = float(np.asarray(st.count)[0, 1]) / 400
    assert p1 > 0.9
