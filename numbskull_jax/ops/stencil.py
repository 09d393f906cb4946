"""Stencil Gibbs engine for lattice factor graphs (no gathers).

The general work-item engine (ops/gibbs.py) gathers every argument value
through an index table. Lattice models (the Ising family, reference
ising/ising.cpp:134-200) have *static regular* adjacency: neighbor values
are whole-array SHIFTS, which XLA compiles to contiguous device-memory
traffic fused with the update arithmetic, with no index table at all.

This engine runs checkerboard (2-color chromatic) Gibbs for grids with
EQUAL pairwise coupling + optional per-site ISTRUE bias, with semantics
identical to the general engine on the same graph:

    pot(k) = w_eq * sum_nbrs eval_EQUAL(k, x_nbr) + w_bias * eval_ISTRUE(k)
    eval_EQUAL = +1 if equal else -1  (reference inference.py:184-192)
    eval_ISTRUE = +1 if all true else -1  (reference inference.py:193-200)
    P(x=1) = sigmoid(pot(1) - pot(0))     [exact for cardinality 2]
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridState:
    x: jax.Array       # (n, m) int32 spins in {0, 1}
    count: jax.Array   # (n, m) int32 tally of value==1


class GridGibbsEngine:
    """Checkerboard Gibbs on an n x m grid with EQUAL couplings."""

    def __init__(self, n: int, m: int, weight: float,
                 bias_weight: float = 0.0):
        self.n, self.m = n, m
        self.weight = float(weight)
        self.bias_weight = float(bias_weight)
        ii = np.arange(n)[:, None]
        jj = np.arange(m)[None, :]
        self._parity = jnp.asarray(((ii + jj) % 2).astype(np.int32))
        # neighbor count (4 interior, 3 edge, 2 corner)
        deg = np.full((n, m), 4, np.float32)
        deg[0, :] -= 1
        deg[-1, :] -= 1
        deg[:, 0] -= 1
        deg[:, -1] -= 1
        self._deg = jnp.asarray(deg)
        self._run = jax.jit(self._run_impl)

    def init_state(self, seed: int = 0) -> GridState:
        key = jax.random.PRNGKey(seed)
        x = jax.random.bernoulli(key, 0.5, (self.n, self.m)).astype(
            jnp.int32)
        return GridState(x=x, count=jnp.zeros((self.n, self.m), jnp.int32))

    # --- core ----------------------------------------------------------

    def _neighbor_sum(self, x):
        xf = x.astype(jnp.float32)
        s = jnp.zeros_like(xf)
        s = s.at[1:, :].add(xf[:-1, :])     # up neighbor
        s = s.at[:-1, :].add(xf[1:, :])     # down
        s = s.at[:, 1:].add(xf[:, :-1])     # left
        s = s.at[:, :-1].add(xf[:, 1:])     # right
        return s

    def _half_step(self, x, parity_val, key):
        s = self._neighbor_sum(x)
        # pot(1)-pot(0) = 2*w_eq*(2s-deg) + 2*w_bias
        dpot = 2.0 * self.weight * (2.0 * s - self._deg) \
            + 2.0 * self.bias_weight
        p1 = jax.nn.sigmoid(dpot)
        u = jax.random.uniform(key, x.shape, dtype=jnp.float32)
        new = (u < p1).astype(jnp.int32)
        return jnp.where(self._parity == parity_val, new, x)

    def _sweep(self, x, key):
        x = self._half_step(x, 0, jax.random.fold_in(key, 0))
        x = self._half_step(x, 1, jax.random.fold_in(key, 1))
        return x

    def _run_impl(self, state: GridState, key, burn, epochs):
        def burn_body(i, x):
            return self._sweep(x, jax.random.fold_in(key, i))

        def epoch_body(i, carry):
            x, cnt = carry
            x = self._sweep(x, jax.random.fold_in(key, i + (1 << 20)))
            return x, cnt + x

        x = jax.lax.fori_loop(0, burn, burn_body, state.x)
        x, cnt = jax.lax.fori_loop(0, epochs, epoch_body, (x, state.count))
        return GridState(x=x, count=cnt)

    # --- public ---------------------------------------------------------

    def inference(self, state: GridState, key, epochs: int,
                  burn: int = 0) -> GridState:
        return self._run(state, key, jnp.int32(burn), jnp.int32(epochs))

    def marginals(self, state: GridState, epochs: int) -> np.ndarray:
        return np.asarray(state.count, np.float64) / max(epochs, 1)
