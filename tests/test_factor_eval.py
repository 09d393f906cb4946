"""Vectorized factor evaluation vs the scalar golden oracle.

Covers every factor function over randomized assignments, arities, and
hypothetical substitution values — the unit-level parity check the
reference never had (its loadfg.py only checks nothing crashes).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from numbskull_jax import golden
from numbskull_jax import types as T
from numbskull_jax.ops.factor_eval import eval_factors

BOOL_FUNCS = [T.FUNC_IMPLY_NATURAL, T.FUNC_OR, T.FUNC_AND, T.FUNC_EQUAL,
              T.FUNC_ISTRUE, T.FUNC_LINEAR, T.FUNC_RATIO, T.FUNC_LOGICAL,
              T.FUNC_IMPLY_MLN]
CAT_FUNCS = [T.FUNC_AND_CAT, T.FUNC_OR_CAT, T.FUNC_EQUAL_CAT_CONST,
             T.FUNC_IMPLY_NATURAL_CAT, T.FUNC_IMPLY_MLN_CAT]
DP_FUNCS = [T.FUNC_DP_GEN_CLASS_PRIOR, T.FUNC_DP_GEN_LF_PRIOR,
            T.FUNC_DP_GEN_LF_PROPENSITY, T.FUNC_DP_GEN_LF_ACCURACY,
            T.FUNC_DP_GEN_LF_CLASS_PROPENSITY, T.FUNC_DP_GEN_DEP_FIXING,
            T.FUNC_DP_GEN_DEP_REINFORCING, T.FUNC_DP_GEN_DEP_EXCLUSIVE,
            T.FUNC_DP_GEN_DEP_SIMILAR]


def _random_case(rng, ftype):
    """Build one random single-factor graph + assignment for `ftype`."""
    if ftype in (T.FUNC_DP_GEN_DEP_FIXING, T.FUNC_DP_GEN_DEP_REINFORCING):
        arity = 3
    elif ftype in DP_FUNCS and ftype != T.FUNC_DP_GEN_CLASS_PRIOR \
            and ftype != T.FUNC_DP_GEN_LF_PRIOR \
            and ftype != T.FUNC_DP_GEN_LF_PROPENSITY:
        arity = 2
    elif ftype in (T.FUNC_DP_GEN_CLASS_PRIOR, T.FUNC_DP_GEN_LF_PRIOR,
                   T.FUNC_DP_GEN_LF_PROPENSITY):
        arity = 1
    elif ftype == T.FUNC_UFO:
        arity = int(rng.integers(2, 5))
    else:
        arity = int(rng.integers(1 if ftype != T.FUNC_EQUAL else 2, 6))

    n_vars = arity + 2
    card = 3 if ftype in DP_FUNCS or ftype in CAT_FUNCS else 2
    variables = T.new_variables(n_vars)
    variables["dataType"] = 1 if ftype in CAT_FUNCS else 0
    variables["cardinality"] = card
    factors = T.new_factors(1)
    factors["factorFunction"][0] = ftype
    factors["arity"][0] = arity
    factors["ftv_offset"][0] = 0
    factors["weightId"][0] = 0
    factors["featureValue"][0] = 1.0
    fmap = T.new_fmap(arity)
    fmap["vid"] = rng.integers(0, n_vars, arity)
    fmap["dense_equal_to"] = rng.integers(0, card, arity)
    var_value = rng.integers(0, card, n_vars)
    var_samp = int(fmap["vid"][rng.integers(0, arity)])
    value = int(rng.integers(0, card))
    return variables, factors, fmap, var_value, var_samp, value


@pytest.mark.parametrize("ftype", BOOL_FUNCS + CAT_FUNCS + DP_FUNCS +
                         [T.FUNC_UFO, T.FUNC_NOOP])
def test_eval_matches_golden(ftype):
    rng = np.random.default_rng(42 + (ftype % 97))
    for trial in range(40):
        variables, factors, fmap, var_value, var_samp, value = \
            _random_case(rng, ftype)
        want = golden.eval_factor(0, var_samp, value, variables, factors,
                                  fmap, var_value)

        arity = int(factors["arity"][0])
        A = arity + 1  # pad one extra to test padding masks
        vids = np.zeros(A, np.int32)
        vids[:arity] = fmap["vid"]
        valid = np.zeros(A, bool)
        valid[:arity] = True
        vals = np.where(vids == var_samp, value, var_value[vids])
        vals = np.where(valid, vals, 0)
        eq = np.zeros(A, np.int32)
        eq[:arity] = fmap["dense_equal_to"]
        cards = np.where(valid, variables["cardinality"][vids], 1)

        got = eval_factors(
            jnp.asarray([ftype], jnp.int32),
            jnp.asarray(vals[None], jnp.int32),
            jnp.asarray(eq[None], jnp.int32),
            jnp.asarray(valid[None]),
            jnp.asarray(cards[None].astype(np.int32)),
            jnp.asarray([arity], jnp.int32),
            present_types=(ftype,))
        assert float(got[0]) == pytest.approx(want, abs=1e-6), \
            (ftype, trial, vals, eq, valid, want, float(got[0]))


def test_absent_types_cost_nothing():
    out = eval_factors(jnp.asarray([T.FUNC_OR], jnp.int32),
                       jnp.ones((1, 2), jnp.int32),
                       jnp.zeros((1, 2), jnp.int32),
                       jnp.ones((1, 2), bool),
                       2 * jnp.ones((1, 2), jnp.int32),
                       jnp.asarray([2], jnp.int32),
                       present_types=())
    assert float(out[0]) == 0.0
