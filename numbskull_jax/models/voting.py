"""Voting-style high-degree factor graphs.

Analog of the reference's degree-scaling experiment apps
(reference: experiments/intro/generate.py and
salt/src/experiment_intro_degree.py:9-88): boolean "vote" variables
connected by factors of controlled degree. Used to stress high-arity
factor evaluation and many-color chromatic schedules.
"""

from __future__ import annotations

import numpy as np

from numbskull_jax import types as T


def voting_model(n_vars: int, n_factors: int, degree: int,
                 func: int = T.FUNC_OR, weight: float = 0.5,
                 n_weights: int = 1, fixed: bool = True, seed: int = 0,
                 evidence_frac: float = 0.0):
    """Random factors of arity `degree`+1 over boolean variables.

    Each factor picks `degree` distinct body variables plus a head.

    Returns (weight, variable, factor, fmap, domain_mask, edges).
    """
    rng = np.random.default_rng(seed)
    arity = degree + 1
    assert arity <= n_vars

    weights = T.new_weights(n_weights)
    weights["isFixed"] = fixed
    weights["initialValue"] = weight

    variables = T.new_variables(n_vars)
    variables["isEvidence"] = (
        rng.random(n_vars) < evidence_frac).astype(np.int8)
    variables["initialValue"] = rng.integers(0, 2, n_vars)
    variables["dataType"] = 0
    variables["cardinality"] = 2

    factors = T.new_factors(n_factors)
    factors["factorFunction"] = func
    factors["weightId"] = rng.integers(0, n_weights, n_factors)
    factors["featureValue"] = 1.0
    factors["arity"] = arity
    factors["ftv_offset"] = np.arange(n_factors, dtype=np.int64) * arity

    # vectorized distinct sampling: argsort random matrix, take first arity
    r = rng.random((n_factors, n_vars)).argsort(axis=1)[:, :arity]
    fmap = T.new_fmap(n_factors * arity)
    fmap["vid"] = r.ravel()
    fmap["dense_equal_to"] = 0

    domain_mask = np.zeros(n_vars, np.bool_)
    return weights, variables, factors, fmap, domain_mask, n_factors * arity


def voting_grouped(n_vars: int, degree: int, weight: float = 1.0,
                   func: int = T.FUNC_AND, fixed: bool = True,
                   seed: int = 0, evidence_frac: float = 0.0):
    """The reference's intro-degree voting family: ``n_vars // degree``
    DISJOINT groups, each one proposition variable plus ``degree`` voter
    variables joined by a single AND factor of arity degree+1
    (reference: experiments/intro/generate.py app.ddlog — `p(p) ^
    v0(v) ^ ... :- voter_voted_for(v, p)`;
    salt/src/experiment_intro_degree.py:9-18 `copies = n_var //
    degree`).

    Returns (weight, variable, factor, fmap, domain_mask, edges).
    """
    rng = np.random.default_rng(seed)
    copies = max(n_vars // max(degree, 1), 1)
    arity = degree + 1
    V = copies * arity
    weights = T.new_weights(1)
    weights["isFixed"] = fixed
    weights["initialValue"] = weight

    variables = T.new_variables(V)
    variables["isEvidence"] = (
        rng.random(V) < evidence_frac).astype(np.int8)
    variables["initialValue"] = rng.integers(0, 2, V)
    variables["dataType"] = 0
    variables["cardinality"] = 2

    factors = T.new_factors(copies)
    factors["factorFunction"] = func
    factors["weightId"] = 0
    factors["featureValue"] = 1.0
    factors["arity"] = arity
    factors["ftv_offset"] = np.arange(copies, dtype=np.int64) * arity

    fmap = T.new_fmap(copies * arity)
    # group-major variable ids: group g owns vars [g*arity, (g+1)*arity)
    fmap["vid"] = np.arange(copies * arity, dtype=np.int64)
    fmap["dense_equal_to"] = 0

    domain_mask = np.zeros(V, np.bool_)
    return weights, variables, factors, fmap, domain_mask, copies * arity
