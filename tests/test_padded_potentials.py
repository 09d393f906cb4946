"""Padded-layout potentials vs the float64 scalar oracle.

``GibbsEngine.padded_potentials`` runs the padded color step's potential
block (``ops/gibbs.py:padded_color_potentials``) for every variable at a
given state. Every case asserts that the padded path is active and that
each (variable, value) potential equals ``golden.potential`` at
abs=1e-4: once per factor function, and on the graph families the
padded layout has to plan (random boolean and mixed categorical graphs,
cardinality 32, arity 33, a lattice, degenerate graphs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from numbskull_jax import golden
from numbskull_jax import types as T
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import ising_color_hint, ising_grid, voting_grouped
from numbskull_jax.ops import GibbsEngine

BOOL_FUNCS = [T.FUNC_IMPLY_NATURAL, T.FUNC_OR, T.FUNC_EQUAL, T.FUNC_AND,
              T.FUNC_ISTRUE, T.FUNC_LINEAR, T.FUNC_RATIO, T.FUNC_LOGICAL,
              T.FUNC_IMPLY_MLN]
CAT_FUNCS = [T.FUNC_AND_CAT, T.FUNC_OR_CAT, T.FUNC_EQUAL_CAT_CONST,
             T.FUNC_IMPLY_NATURAL_CAT, T.FUNC_IMPLY_MLN_CAT]
# data-programming factors: argument roles, y = boolean class variable,
# l = cardinality-3 labeling-function output (value 2 abstains)
DP_ROLES = {
    T.FUNC_DP_GEN_CLASS_PRIOR: "y",
    T.FUNC_DP_GEN_LF_PRIOR: "l",
    T.FUNC_DP_GEN_LF_PROPENSITY: "l",
    T.FUNC_DP_GEN_LF_ACCURACY: "yl",
    T.FUNC_DP_GEN_LF_CLASS_PROPENSITY: "yl",
    T.FUNC_DP_GEN_DEP_FIXING: "yll",
    T.FUNC_DP_GEN_DEP_REINFORCING: "yll",
    T.FUNC_DP_GEN_DEP_EXCLUSIVE: "ll",
    T.FUNC_DP_GEN_DEP_SIMILAR: "ll",
}


def assert_padded_matches_golden(w, v, f, fm, seed, cg=None):
    """Padded path active, and every (variable, value) potential at a
    seeded random state equals the scalar oracle."""
    if cg is None:
        cg = compile_graph(w, v, f, fm)
    eng = GibbsEngine(cg)
    assert eng.padded_meta is not None, "padded path inactive"
    rng = np.random.default_rng(seed)
    x = np.array([rng.integers(0, c) for c in v["cardinality"]], np.int64)
    st = dataclasses.replace(eng.init_state(),
                             var_value=jnp.asarray(x.astype(np.int32)))
    pot = np.asarray(eng.padded_potentials(st), np.float64)
    wv = np.asarray(cg.weight_init, np.float64)
    for vid in range(cg.n_vars):
        for k in range(int(v["cardinality"][vid])):
            want = golden.potential(v, f, fm, wv, vid, k, x)
            assert pot[vid, k] == pytest.approx(want, abs=1e-4), \
                (vid, k, pot[vid, k], want)


def _factors(rng, funcs, arities, n_weights):
    f = T.new_factors(len(arities))
    f["factorFunction"] = funcs
    f["weightId"] = rng.integers(0, n_weights, len(arities))
    f["featureValue"] = 1.0
    f["arity"] = arities
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(arities)[:-1]))
    return f


def _weights(rng, n):
    w = T.new_weights(n)
    w["isFixed"] = True
    w["initialValue"] = rng.normal(size=n) * 0.7
    return w


def _one_type_graph(code, seed=0, n_factors=12):
    """A small graph whose factors all use function ``code``, with
    variables of the kinds that function reads."""
    rng = np.random.default_rng(seed)
    if code in DP_ROLES:
        roles = DP_ROLES[code]
        ny, nl = 6, 10
        v = T.new_variables(ny + nl)
        v["cardinality"] = [2] * ny + [3] * nl
        pools = {"y": np.arange(ny), "l": ny + np.arange(nl)}
        fm = T.new_fmap(n_factors * len(roles))
        for i in range(n_factors):
            picks = []
            for r in roles:
                pool = [u for u in pools[r] if u not in picks]
                picks.append(int(rng.choice(pool)))
            fm["vid"][i * len(roles):(i + 1) * len(roles)] = picks
        arities = np.full(n_factors, len(roles))
    else:
        n_vars = 10
        v = T.new_variables(n_vars)
        if code in CAT_FUNCS:
            v["dataType"] = 1
            v["cardinality"] = 3
        elif code == T.FUNC_UFO:
            v["cardinality"] = 3
        else:
            v["cardinality"] = 2
        lo = 3 if code == T.FUNC_UFO else 1
        arities = rng.integers(lo, 4, n_factors)
        fm = T.new_fmap(int(arities.sum()))
        off = 0
        for a in arities:
            fm["vid"][off:off + a] = rng.choice(n_vars, a, replace=False)
            off += a
        if code in CAT_FUNCS:
            fm["dense_equal_to"] = rng.integers(0, 3, len(fm))
    v["isEvidence"] = rng.integers(0, 2, len(v))
    f = _factors(rng, code, arities, 3)
    return _weights(rng, 3), v, f, fm


@pytest.mark.parametrize("name", sorted(T.FACTORS))
def test_padded_potentials_each_factor_function(name):
    w, v, f, fm = _one_type_graph(T.FACTORS[name])
    assert_padded_matches_golden(w, v, f, fm, seed=1)


def _random_bool_graph(seed, n_vars=24, n_factors=40, amax=4):
    rng = np.random.default_rng(seed)
    v = T.new_variables(n_vars)
    v["cardinality"] = 2
    v["initialValue"] = rng.integers(0, 2, n_vars)
    v["isEvidence"] = rng.integers(0, 2, n_vars)
    arities = rng.integers(1, amax + 1, n_factors)
    f = _factors(rng, rng.choice(BOOL_FUNCS, n_factors), arities, 5)
    fm = T.new_fmap(int(arities.sum()))
    fm["vid"] = rng.integers(0, n_vars, len(fm))
    return _weights(rng, 5), v, f, fm


def _random_mixed_graph(seed, n_vars=20, n_factors=30, max_card=3):
    """Boolean + categorical vars (cardinality up to ``max_card``),
    categorical + DP factor functions."""
    rng = np.random.default_rng(seed)
    v = T.new_variables(n_vars)
    is_cat = rng.random(n_vars) < 0.4
    v["dataType"] = is_cat.astype(np.int16)
    v["cardinality"] = np.where(is_cat, rng.integers(3, max_card + 1,
                                                     n_vars), 2)
    v["isEvidence"] = rng.integers(0, 2, n_vars)
    funcs = [T.FUNC_OR, T.FUNC_AND, T.FUNC_EQUAL, T.FUNC_ISTRUE,
             T.FUNC_AND_CAT, T.FUNC_OR_CAT, T.FUNC_EQUAL_CAT_CONST,
             T.FUNC_IMPLY_NATURAL_CAT, T.FUNC_IMPLY_MLN_CAT,
             T.FUNC_DP_GEN_CLASS_PRIOR, T.FUNC_DP_GEN_LF_PROPENSITY,
             T.FUNC_DP_GEN_LF_ACCURACY, T.FUNC_DP_GEN_DEP_SIMILAR,
             T.FUNC_DP_GEN_DEP_EXCLUSIVE]
    arities = rng.integers(1, 4, n_factors)
    ftype = rng.choice(funcs, n_factors)
    ftype[arities < 2] = T.FUNC_ISTRUE
    two_arg = np.isin(ftype, [T.FUNC_DP_GEN_LF_ACCURACY,
                              T.FUNC_DP_GEN_DEP_SIMILAR,
                              T.FUNC_DP_GEN_DEP_EXCLUSIVE])
    arities[two_arg] = 2
    f = _factors(rng, ftype, arities, 4)
    fm = T.new_fmap(int(arities.sum()))
    fm["vid"] = rng.integers(0, n_vars, len(fm))
    fm["dense_equal_to"] = [rng.integers(0, v["cardinality"][u])
                            for u in fm["vid"]]
    return _weights(rng, 4), v, f, fm


@pytest.mark.parametrize("seed", [0, 7])
def test_padded_potentials_random_boolean(seed):
    assert_padded_matches_golden(*_random_bool_graph(seed), seed=seed + 1)


def test_padded_potentials_ising_lattice():
    n = 12
    w, v, f, fm, dm, e = ising_grid(n, n, weight=0.37)
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, n))
    assert_padded_matches_golden(w, v, f, fm, seed=3, cg=cg)


@pytest.mark.parametrize("seed", [2, 9])
def test_padded_potentials_mixed_categorical(seed):
    assert_padded_matches_golden(*_random_mixed_graph(seed), seed=seed + 1)


@pytest.mark.parametrize("seed", [4, 11])
def test_padded_potentials_cardinality_32(seed):
    w, v, f, fm = _random_mixed_graph(seed, max_card=32)
    assert int(v["cardinality"].max()) > 8
    assert_padded_matches_golden(w, v, f, fm, seed=seed + 1)


def test_padded_potentials_arity_33():
    """Arity past one 32-bit word, including rows whose own argument
    position is >= 32."""
    degree = 33
    w, v, f, fm, dm, e = voting_grouped((degree + 1) * 4, degree,
                                        func=T.FUNC_OR, weight=0.8,
                                        seed=degree)
    assert_padded_matches_golden(w, v, f, fm, seed=1)


def _edge_graph(n_vars, specs, all_ev=False):
    v = T.new_variables(n_vars)
    v["cardinality"] = 2
    if all_ev:
        v["isEvidence"] = 1
    w = T.new_weights(1)
    w["initialValue"] = 0.5
    w["isFixed"] = True
    f = T.new_factors(len(specs))
    fm = T.new_fmap(sum(len(s[1]) for s in specs))
    off = 0
    for i, (ff, vids) in enumerate(specs):
        f["factorFunction"][i] = ff
        f["arity"][i] = len(vids)
        f["ftv_offset"][i] = off
        f["featureValue"][i] = 1.0
        fm["vid"][off:off + len(vids)] = vids
        off += len(vids)
    return w, v, f, fm


def test_padded_potentials_planner_edge_cases():
    """Degenerate graphs plan into the padded layout: isolated
    variables, self-pair factors, all-evidence and one-variable
    graphs."""
    for w, v, f, fm in (
            _edge_graph(5, [(T.FUNC_ISTRUE, [0])]),                 # isolated
            _edge_graph(3, [(T.FUNC_EQUAL, [1, 1])]),               # self-pair
            _edge_graph(4, [(T.FUNC_EQUAL, [0, 1])], all_ev=True),  # evidence
            _edge_graph(1, [(T.FUNC_ISTRUE, [0])])):                # one var
        assert_padded_matches_golden(w, v, f, fm, seed=0)
