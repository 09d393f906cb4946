"""Two-variable "coin" model with a closed-form partition function.

Equivalent of the active generator in the reference's C++
tool (reference: ising/ising.cpp:202-318): N independent copies of a pair
(x1, x2) with ISTRUE(x1) @ w0, ISTRUE(x2) @ w1, EQUAL(x1, x2) @ w2. With
weights (a, b, c), the exact joint is

    P(x1, x2) ∝ exp(a*(2*x1-1) + b*(2*x2-1) + c*(2*[x1==x2]-1))

which provides ground-truth marginals for sampler validation and ground
truth data for weight-learning validation.
"""

from __future__ import annotations

import numpy as np

from numbskull_jax import types as T


def coin_exact_marginal(a: float, b: float, c: float) -> np.ndarray:
    """Exact P over (x1,x2) in order 00,01,10,11."""
    logits = np.array([-a - b + c, -a + b - c, a - b - c, a + b + c])
    z = np.exp(logits - logits.max())
    return z / z.sum()


def coin_model(n_copies: int, a: float = 1.0, b: float = 1.0, c: float = 0.5,
               evidence: bool = True, weight_init=(0.0, 0.0, 0.0),
               fixed: bool = False, seed: int = 0):
    """N copies of the coin pair, each with its values drawn from the
    exact joint and marked evidence (for learning), or free (for
    inference).

    Returns (weight, variable, factor, fmap, domain_mask, edges).
    """
    rng = np.random.default_rng(seed)
    p = coin_exact_marginal(a, b, c)
    draws = rng.choice(4, size=n_copies, p=p)

    weights = T.new_weights(3)
    weights["isFixed"] = fixed
    weights["initialValue"] = np.asarray(weight_init, np.float64)

    V = 2 * n_copies
    variables = T.new_variables(V)
    variables["isEvidence"] = 1 if evidence else 0
    variables["initialValue"][0::2] = (draws >> 1) & 1
    variables["initialValue"][1::2] = draws & 1
    variables["dataType"] = 0
    variables["cardinality"] = 2

    F = 3 * n_copies
    factors = T.new_factors(F)
    fmap = T.new_fmap(4 * n_copies)
    for i in range(n_copies):
        x1, x2 = 2 * i, 2 * i + 1
        f = 3 * i
        e = 4 * i
        factors["factorFunction"][f] = T.FUNC_ISTRUE
        factors["weightId"][f] = 0
        factors["arity"][f] = 1
        factors["ftv_offset"][f] = e
        fmap["vid"][e] = x1

        factors["factorFunction"][f + 1] = T.FUNC_ISTRUE
        factors["weightId"][f + 1] = 1
        factors["arity"][f + 1] = 1
        factors["ftv_offset"][f + 1] = e + 1
        fmap["vid"][e + 1] = x2

        factors["factorFunction"][f + 2] = T.FUNC_EQUAL
        factors["weightId"][f + 2] = 2
        factors["arity"][f + 2] = 2
        factors["ftv_offset"][f + 2] = e + 2
        fmap["vid"][e + 2] = x1
        fmap["vid"][e + 3] = x2
    factors["featureValue"] = 1.0

    domain_mask = np.zeros(V, np.bool_)
    return weights, variables, factors, fmap, domain_mask, 4 * n_copies
