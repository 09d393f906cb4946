"""Weight learning: parameter recovery on models with exact ground truth.

The reference's learning test (test_lf_learning.py) prints weights for
human inspection; here we assert recovery tolerances on models whose data
is drawn from the exact joint implied by the factor semantics.
"""

import numpy as np
import pytest

import jax

from numbskull_jax.compile import compile_graph
from numbskull_jax.models import coin_model, lf_model
from numbskull_jax.ops import GibbsEngine, LearnParams


def _learn(args, epochs, stepsize, decay=1.0, burn=10, lp=LearnParams(),
           seed=0):
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    eng = GibbsEngine(cg)
    st = eng.init_state()
    st = eng.learn(st, jax.random.PRNGKey(seed), epochs, stepsize,
                   decay=decay, burn=burn, lp=lp)
    return np.asarray(st.weight_value)


def test_coin_learning_recovers_weights():
    """Evidence pairs drawn from the exact coin joint; SGD should recover
    (a, b, c) — the reference's own ground-truth scheme
    (ising/ising.cpp:202-318)."""
    a, b, c = 0.8, -0.5, 0.4
    args = coin_model(4000, a, b, c, evidence=True,
                      weight_init=(0.0, 0.0, 0.0), fixed=False, seed=3)
    lp = LearnParams(regularization=2, reg_param=1e-4)
    w = _learn(args, epochs=150, stepsize=0.1, decay=0.99, lp=lp)
    assert w[0] == pytest.approx(a, abs=0.15)
    assert w[1] == pytest.approx(b, abs=0.15)
    assert w[2] == pytest.approx(c, abs=0.15)


def test_lf_learning_recovers_accuracy_ordering():
    """Labeling-function model: learned accuracies recover magnitude and
    ordering (analog of reference test_lf_learning.py main)."""
    prior, acc = 0.0, [1.0, 0.4]
    args = lf_model(prior, acc, copies=2000, seed=11)
    lp = LearnParams(regularization=1, reg_param=0.01, truncation=10,
                     learn_non_evidence=True)
    learn_epochs = 200
    w = _learn(args, epochs=learn_epochs, stepsize=0.05,
               decay=0.01 ** (1.0 / learn_epochs), burn=20, lp=lp)
    assert abs(w[0] - prior) < 0.25
    assert w[1] == pytest.approx(acc[0], abs=0.3)
    assert w[2] == pytest.approx(acc[1], abs=0.3)
    assert w[1] > w[2]  # ordering always preserved


def test_fixed_weights_not_updated():
    args = coin_model(100, evidence=True, weight_init=(0.7, 0.7, 0.7),
                      fixed=True)
    w = _learn(args, epochs=30, stepsize=0.1)
    assert (w == np.float32(0.7)).all()


def test_l2_shrinks_toward_zero():
    """With zero gradient signal (balanced data) strong L2 shrinks."""
    args = coin_model(500, a=0.0, b=0.0, c=0.0, evidence=True,
                      weight_init=(1.0, 1.0, 1.0), fixed=False, seed=5)
    lp = LearnParams(regularization=2, reg_param=0.5)
    w = _learn(args, epochs=100, stepsize=0.05, lp=lp)
    assert (np.abs(w) < 0.5).all()


def test_learn_non_evidence_flag():
    """With all-query variables and learn_non_evidence=False, no gradient
    flows (reference learning.py:71-72)."""
    args = coin_model(50, evidence=False, weight_init=(0.3, 0.3, 0.3),
                      fixed=False)
    lp = LearnParams(regularization=0, learn_non_evidence=False)
    w = _learn(args, epochs=20, stepsize=0.1, lp=lp)
    assert w == pytest.approx([0.3, 0.3, 0.3], abs=1e-6)
