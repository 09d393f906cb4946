"""Stencil (lattice) engine vs exact enumeration and the general engine."""

import numpy as np
import pytest

import jax

from numbskull_jax import golden
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import ising_color_hint, ising_grid
from numbskull_jax.ops import GibbsEngine
from numbskull_jax.ops.stencil import GridGibbsEngine


def _exact(n, m, w):
    wt, v, f, fm, dm, e = ising_grid(n, m, weight=w)
    return golden.exact_marginals(v, f, fm, wt["initialValue"])


def test_xla_stencil_matches_exact():
    eng = GridGibbsEngine(3, 3, 0.4)
    st = eng.init_state()
    st = eng.inference(st, jax.random.PRNGKey(0), epochs=8000, burn=300)
    marg = eng.marginals(st, 8000)
    exact = _exact(3, 3, 0.4)
    assert np.abs(marg.ravel() - exact[:, 1]).max() < 0.04


def test_stencil_matches_general_engine():
    """Same model through the general work-item engine and the stencil
    engine: same stationary marginals."""
    n = 4
    w, v, f, fm, dm, e = ising_grid(n, n, weight=0.5)
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, n))
    eng_g = GibbsEngine(cg)
    st = eng_g.init_state()
    st = eng_g.inference(st, jax.random.PRNGKey(3), 6000, burn=300)
    marg_g = np.asarray(st.count, np.float64)[:, 1] / 6000

    eng_s = GridGibbsEngine(n, n, 0.5)
    gs = eng_s.init_state()
    gs = eng_s.inference(gs, jax.random.PRNGKey(4), 6000, burn=300)
    marg_s = eng_s.marginals(gs, 6000).ravel()

    assert np.abs(marg_g - marg_s).max() < 0.05


def test_stencil_bias_weight():
    """ISTRUE per-site bias pushes marginals off 0.5 as sigmoid(2b)."""
    eng = GridGibbsEngine(4, 4, 0.0, bias_weight=0.7)
    st = eng.init_state()
    st = eng.inference(st, jax.random.PRNGKey(0), epochs=8000, burn=100)
    marg = eng.marginals(st, 8000)
    want = 1.0 / (1.0 + np.exp(-1.4))
    assert marg.mean() == pytest.approx(want, abs=0.03)
