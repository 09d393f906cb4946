"""Multi-device tests on the 8-device virtual CPU mesh (conftest.py).

The reference had NO single-process distributed test harness (SURVEY.md
§4: multi-node was only validated on live salt clusters); here mesh
shapes are swept and results cross-checked statistically and against
exact joints.
"""

import numpy as np
import pytest

import jax

from numbskull_jax import golden
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import (
    coin_exact_marginal, coin_model, ising_color_hint, ising_grid,
)
from numbskull_jax.ops import GibbsEngine, LearnParams
from numbskull_jax.parallel.mesh import make_mesh
from numbskull_jax.parallel.sharded import ShardedGibbsEngine


def _sharded_marginals(cg, mesh, epochs=4000, burn=200, seed=0):
    eng = ShardedGibbsEngine(cg, mesh)
    st = eng.init_state()
    st = eng.inference(st, jax.random.PRNGKey(seed), epochs, burn=burn)
    return eng.marginals(st, epochs)


def test_needs_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1), (4, 2)])
def test_mesh_shapes_match_exact(shape):
    """Same exact coin marginals for any (chains, graph) mesh shape."""
    a, b, c = 0.4, -0.3, 0.6
    args = coin_model(1, a, b, c, evidence=False, weight_init=(a, b, c),
                      fixed=True)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    mesh = make_mesh(*shape)
    marg = _sharded_marginals(cg, mesh, epochs=4000 // shape[0])
    p = coin_exact_marginal(a, b, c)
    assert marg[0, 1] == pytest.approx(p[2] + p[3], abs=0.04)
    assert marg[1, 1] == pytest.approx(p[1] + p[3], abs=0.04)


def test_graph_sharding_matches_exact_ising():
    """Graph-sharded sweep = exact chromatic Gibbs (no halo staleness)."""
    args = ising_grid(3, 3, weight=0.4)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(3, 3))
    marg = _sharded_marginals(cg, make_mesh(2, 4), epochs=4000)
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    assert np.abs(marg[:, 1] - exact[:, 1]).max() < 0.05


def test_chains_reduce_variance():
    """8 chains of N epochs ~ std of 1 chain of 8N epochs."""
    args = coin_model(1, 0.2, 0.2, 0.2, evidence=False,
                      weight_init=(0.2, 0.2, 0.2), fixed=True)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    marg = _sharded_marginals(cg, make_mesh(8, 1), epochs=1000)
    p = coin_exact_marginal(0.2, 0.2, 0.2)
    assert marg[0, 1] == pytest.approx(p[2] + p[3], abs=0.03)


def test_distributed_learning_recovers_weights():
    """Gradient psum over graph axis + pmean over chains recovers the
    coin weights (replaces reference master/minion dw summation,
    numbskull_master.py:223-224)."""
    a, b, c = 0.8, -0.5, 0.4
    args = coin_model(2000, a, b, c, evidence=True, weight_init=(0, 0, 0),
                      fixed=False, seed=3)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    eng = ShardedGibbsEngine(cg, make_mesh(2, 4))
    st = eng.init_state()
    st = eng.learn(st, jax.random.PRNGKey(1), epochs=150, stepsize=0.1,
                   decay=0.99, burn=10,
                   lp=LearnParams(regularization=2, reg_param=1e-4))
    got = np.asarray(st.weight_value)
    assert got[0] == pytest.approx(a, abs=0.15)
    assert got[1] == pytest.approx(b, abs=0.15)
    assert got[2] == pytest.approx(c, abs=0.15)


def test_sharded_vs_single_device_statistics():
    """Mesh engine and single-device engine agree statistically."""
    args = ising_grid(4, 4, weight=0.3)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(4, 4))
    marg_sharded = _sharded_marginals(cg, make_mesh(1, 8), epochs=5000)
    eng = GibbsEngine(cg)
    st = eng.init_state()
    st = eng.inference(st, jax.random.PRNGKey(0), 5000, burn=200)
    marg_single = np.asarray(st.count, np.float64) / 5000
    assert np.abs(marg_sharded[:, 1] - marg_single[:, 1]).max() < 0.05
