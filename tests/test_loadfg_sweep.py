"""End-to-end learn+infer crash sweep over EVERY factor function.

The reference ships this as a top-level script (`/root/reference/
loadfg.py:38-81`: for each entry of inference.FACTORS build a tiny
2-or-3-variable graph with one factor of that type, run 100 learning +
100 inference epochs through the public NumbSkull API, print counts).
Here the same sweep is a test: every function code must survive the
FULL pipeline — compile (attachments, coloring, plans), learning
(dual-chain SGD), inference (tallies) — with finite weights and tallies
inside [0, epochs]. Categorical-only functions additionally sweep with
cardinality-3 variables, which the reference's script never covered.
"""

import numpy as np
import pytest

import numbskull_jax as nt
from numbskull_jax import types as T


def _tiny_graph(code, card):
    n_vars = 3 if code in (T.FUNC_DP_GEN_DEP_FIXING,
                           T.FUNC_DP_GEN_DEP_REINFORCING) else 2
    weight = T.new_weights(1)
    weight[0]["isFixed"] = False
    weight[0]["initialValue"] = 1
    variable = T.new_variables(n_vars)
    variable["isEvidence"] = 0
    variable["initialValue"] = 0
    variable["dataType"] = 0
    variable["cardinality"] = card
    # one evidence var so learning has a gradient signal
    variable["isEvidence"][0] = 1
    variable["initialValue"][0] = 1
    factor = T.new_factors(1)
    factor[0]["factorFunction"] = code
    factor[0]["weightId"] = 0
    factor[0]["featureValue"] = 1
    factor[0]["arity"] = n_vars
    factor[0]["ftv_offset"] = 0
    fmap = T.new_fmap(n_vars)
    fmap["vid"] = np.arange(n_vars)
    fmap["dense_equal_to"] = 0
    domain_mask = np.zeros(n_vars, np.bool_)
    return weight, variable, factor, fmap, domain_mask, n_vars


@pytest.mark.parametrize("name,code", sorted(T.FACTORS.items()))
@pytest.mark.parametrize(
    "card", [2, pytest.param(3, marks=pytest.mark.slow)])
def test_learn_infer_survives(name, code, card):
    epochs = 40
    ns = nt.NumbSkull(n_inference_epoch=epochs, n_learning_epoch=20,
                      burn_in=5, stepsize=0.05, quiet=True)
    ns.loadFactorGraph(*_tiny_graph(code, card))
    ns.learning(out=False)
    ns.inference(out=False)
    fg = ns.factorGraphs[0]
    w = np.asarray(fg.getWeights(), np.float64)
    assert np.isfinite(w).all(), (name, card, w)
    cnt = np.asarray(fg.state.count)
    assert (cnt >= 0).all() and (cnt <= epochs).all(), (name, card)
    marg = fg.full_marginals(epochs)
    assert np.isfinite(marg).all()
    np.testing.assert_allclose(marg.sum(axis=1), 1.0, atol=1e-6)
