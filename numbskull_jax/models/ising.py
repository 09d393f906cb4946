"""Ising grid model generator.

Equivalent of the commented-out N x M Ising generator in the
reference's C++ tool (reference: ising/ising.cpp:134-200): boolean grid
variables, EQUAL pairwise factors between 4-neighbors, one shared fixed
weight. The grid is 2-colorable, so the chromatic sweep runs in exactly
two fused color steps — the canonical Gibbs benchmark.
"""

from __future__ import annotations

import numpy as np

from numbskull_jax import types as T


def ising_grid(n: int, m: int, weight: float = 0.1, fixed: bool = True,
               seed: int = 0):
    """Build an n x m Ising grid with EQUAL coupling factors.

    Returns (weight, variable, factor, fmap, domain_mask, edges).
    """
    rng = np.random.default_rng(seed)
    V = n * m
    weights = T.new_weights(1)
    weights[0]["isFixed"] = fixed
    weights[0]["initialValue"] = weight

    variables = T.new_variables(V)
    variables["isEvidence"] = 0
    variables["initialValue"] = rng.integers(0, 2, V)
    variables["dataType"] = 0
    variables["cardinality"] = 2

    # factor order matches the reference generator (ising/ising.cpp:162-196
    # and native/graphgen.cpp): per cell in row-major order, the up-coupling
    # then the left-coupling
    ii, jj = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    vid = ii * m + jj
    pair_list = np.empty((2 * n * m, 2), np.int64)
    has_up = ii > 0
    has_left = jj > 0
    n_per_cell = has_up.astype(np.int64) + has_left
    starts = np.concatenate(([0], np.cumsum(n_per_cell)[:-1]))
    pair_list[starts[has_up], 0] = vid[has_up]
    pair_list[starts[has_up], 1] = vid[has_up] - m
    left_pos = starts + has_up
    pair_list[left_pos[has_left], 0] = vid[has_left]
    pair_list[left_pos[has_left], 1] = vid[has_left] - 1
    pairs = pair_list[:int(n_per_cell.sum())]
    F = len(pairs)
    factors = T.new_factors(F)
    factors["factorFunction"] = T.FUNC_EQUAL
    factors["weightId"] = 0
    factors["featureValue"] = 1.0
    factors["arity"] = 2
    factors["ftv_offset"] = np.arange(F, dtype=np.int64) * 2

    fmap = T.new_fmap(2 * F)
    fmap["vid"] = pairs.ravel()
    fmap["dense_equal_to"] = 0

    domain_mask = np.zeros(V, np.bool_)
    return weights, variables, factors, fmap, domain_mask, 2 * F


def ising_color_hint(n: int, m: int) -> np.ndarray:
    """Checkerboard 2-coloring of the grid (pass to compile_graph)."""
    idx = np.arange(n * m)
    return (idx // m + idx % m) % 2


def potts_grid(n: int, m: int, card: int, weight: float = 0.1,
               fixed: bool = True, seed: int = 0):
    """n x m Potts grid: cardinality-``card`` variables with EQUAL
    coupling factors (the all-equal semantics of FUNC_EQUAL, reference
    numbskull/inference.py:169-176, applies at any cardinality).

    Variables keep dataType==0: in the reference's vmap semantics
    (dataloading.py:34-46) that is the *dense* adjacency — the factor
    contributes to the potential of EVERY candidate value, which is what
    a Potts coupling means (dataType==1 attaches a factor only to its
    dense_equal_to slot). The reference restricted dataType==0 to
    cardinality 2; this framework generalizes the dense slot to any
    cardinality. High cardinality stresses the engine's per-value
    candidate axis.

    Returns (weight, variable, factor, fmap, domain_mask, edges).
    """
    w, v, f, fm, dm, e = ising_grid(n, m, weight=weight, fixed=fixed,
                                    seed=seed)
    rng = np.random.default_rng(seed + 1)
    v["cardinality"] = card
    v["initialValue"] = rng.integers(0, card, len(v))
    return w, v, f, fm, dm, e
