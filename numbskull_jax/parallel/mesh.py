"""Device-mesh helpers.

The reference scales out with a SaltStack master/minion cluster, a custom
TCP msgpack channel, and Postgres graph distribution (reference:
salt/src/, SURVEY.md §2.6). Here the whole control+data plane collapses
into a `jax.sharding.Mesh` with two axes:

- ``chains``: replica axis — independent Gibbs chains (the reference's
  var_copies / weight_copies, reference factorgraph.py:48-53, generalized
  into real parallelism). Marginal tallies reduce across it; learning
  gradients are averaged across it (data parallelism).
- ``graph``: model-parallel axis — factor work items are sharded; each
  device computes partial potentials for its factors and a ``psum``
  replaces the reference's per-epoch boundary-variable shipping
  (salt/src/messages.py:1253-1319). Unlike the reference's
  one-epoch-stale halo semantics (SURVEY.md §3.4), the psum design is
  EXACT synchronous chromatic Gibbs at any device count.

The mesh follows the algorithm, not a physical topology: the cards of
one GPU host reach each other all to all over NVLink at the same rate,
so the devices are simply laid out in order.
"""

from __future__ import annotations

import jax
import numpy as np


CHAINS_AXIS = "chains"
GRAPH_AXIS = "graph"


def make_mesh(n_chains: int = 1, n_graph: int | None = None,
              devices=None) -> jax.sharding.Mesh:
    """Build a (chains, graph) mesh over the given (or all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_graph is None:
        assert len(devices) % n_chains == 0, (len(devices), n_chains)
        n_graph = len(devices) // n_chains
    assert n_chains * n_graph <= len(devices), \
        (n_chains, n_graph, len(devices))
    devs = np.asarray(devices[:n_chains * n_graph]).reshape(
        n_chains, n_graph)
    return jax.sharding.Mesh(devs, (CHAINS_AXIS, GRAPH_AXIS))
