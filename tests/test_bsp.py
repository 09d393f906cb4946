"""Bulk-synchronous partitioned engine (reference distributed semantics).

Checks the partitioned execution path end to end: exact message algebra
(the UFO/PF generalization), marginal parity vs exact joints for both
boundary treatments, distributed weight learning (delta summation), and
traffic accounting. Reference analog: there was NO single-process
distributed test at all (SURVEY.md §4: real salt clusters only).
"""

import numpy as np
import pytest

import jax

from numbskull_jax import golden
from numbskull_jax import types as T
from numbskull_jax.models import coin_model
from numbskull_jax.ops.gibbs import LearnParams
from numbskull_jax.parallel.bsp import BSPEngine, factor_owner


def _random_graph(seed=3, n_vars=10, n_factors=18, categorical=False):
    rng = np.random.default_rng(seed)
    v = T.new_variables(n_vars)
    v["dataType"] = 0
    v["cardinality"] = 2
    if categorical:
        is_cat = rng.random(n_vars) < 0.3
        v["dataType"] = is_cat.astype(np.int16)
        v["cardinality"] = np.where(is_cat, 3, 2)
    v["initialValue"] = rng.integers(0, 2, n_vars)
    w = T.new_weights(4)
    w["isFixed"] = True
    w["initialValue"] = rng.normal(size=4) * 0.4
    funcs = [T.FUNC_OR, T.FUNC_AND, T.FUNC_EQUAL, T.FUNC_ISTRUE,
             T.FUNC_LOGICAL]
    arities = rng.integers(1, 4, n_factors)
    f = T.new_factors(n_factors)
    f["factorFunction"] = rng.choice(funcs, n_factors)
    f["weightId"] = rng.integers(0, 4, n_factors)
    f["featureValue"] = 1.0
    f["arity"] = arities
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(arities)[:-1]))
    E = int(arities.sum())
    fm = T.new_fmap(E)
    fm["vid"] = rng.integers(0, n_vars, E)
    for j in range(E):
        fm["dense_equal_to"][j] = rng.integers(
            0, v["cardinality"][fm["vid"][j]])
    return w, v, f, fm


def test_messages_equal_remote_potential_exactly():
    """ext(v, k) must equal the golden potential restricted to factors
    owned by OTHER parts — the algebraic contract of the UFO/PF
    generalization (reference messages.py:942-1066, 1332-1355)."""
    w, v, f, fm = _random_graph(seed=7, categorical=True)
    part = np.arange(len(v)) % 3
    eng = BSPEngine(w, v, f, fm, part, mode="messages")
    states = eng.init_states()
    ext = np.asarray(eng.messages(states))
    owner = factor_owner(f, fm, part)
    wv = w["initialValue"]
    var_value = v["initialValue"].astype(np.int64)
    for vid in range(len(v)):
        mine = np.flatnonzero(owner == part[vid])
        others = np.flatnonzero(owner != part[vid])
        for k in range(int(v["cardinality"][vid])):
            total = golden.potential(v, f, fm, wv, vid, k, var_value)
            local = golden.potential(v, f, fm, wv, vid, k, var_value,
                                     factors_to_skip=others)
            assert ext[vid, k] == pytest.approx(total - local, abs=1e-4), \
                (vid, k)


def test_exchange_makes_chains_globally_consistent():
    w, v, f, fm = _random_graph(seed=5)
    part = np.arange(len(v)) % 2
    eng = BSPEngine(w, v, f, fm, part, mode="values")
    states = eng.init_states()
    states = eng.inference(states, jax.random.PRNGKey(0), epochs=3, burn=2)
    vv = [np.asarray(s.var_value) for s in states]
    for p in range(1, len(vv)):
        assert (vv[p] == vv[0]).all()


@pytest.mark.parametrize("mode", ["values", pytest.param("messages", marks=pytest.mark.slow)])
def test_bsp_marginals_match_exact(mode):
    """Partitioned marginals vs exact joint (boolean graph, moderate
    coupling): the stale-halo approximation must land within Monte-Carlo
    tolerance, as the reference's cluster mode implicitly assumes."""
    w, v, f, fm = _random_graph(seed=11, n_vars=9, n_factors=14)
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    part = np.arange(len(v)) % 3
    eng = BSPEngine(w, v, f, fm, part, mode=mode)
    states = eng.init_states()
    epochs = 3000
    states = eng.inference(states, jax.random.PRNGKey(1), epochs=epochs,
                           burn=100, sync_every=10)
    marg = eng.marginals(states, epochs)
    err = np.abs(marg[:, :2] - exact[:, :2]).max()
    assert err < 0.06, err


@pytest.mark.parametrize("mode", ["values", pytest.param("messages", marks=pytest.mark.slow)])
def test_bsp_learning_recovers_coin_weights(mode):
    """Distributed SGD (per-part deltas summed) recovers the coin weights;
    the partition splits every (x1, x2) pair so EVERY factor-coupled pair
    straddles parts."""
    a, b, c = 0.8, -0.5, 0.4
    args = coin_model(1500, a, b, c, evidence=True,
                      weight_init=(0.0, 0.0, 0.0), fixed=False, seed=3)
    w, v, f, fm, dm, e = args
    part = np.arange(len(v)) % 2        # x1 on part 0, x2 on part 1
    eng = BSPEngine(w, v, f, fm, part, mode=mode, domain_mask=dm)
    states = eng.init_states()
    lp = LearnParams(regularization=2, reg_param=1e-4)
    states = eng.learn(states, jax.random.PRNGKey(0), epochs=120,
                       stepsize=0.1, decay=0.99, burn=5, lp=lp)
    got = eng.weights(states)
    assert got[0] == pytest.approx(a, abs=0.2)
    assert got[1] == pytest.approx(b, abs=0.2)
    assert got[2] == pytest.approx(c, abs=0.2)


@pytest.mark.parametrize("mode", ["values", pytest.param("messages", marks=pytest.mark.slow)])
def test_bsp_multi_device_placement(mode):
    """Parts pinned to distinct devices: states live where assigned,
    exchanges hop through the coordinator, marginals still match the
    exact joint."""
    devices = jax.devices()[:3]
    if len(devices) < 3:
        pytest.skip("needs >= 3 devices")
    w, v, f, fm = _random_graph(seed=11, n_vars=9, n_factors=14)
    exact = golden.exact_marginals(v, f, fm, w["initialValue"])
    part = np.arange(len(v)) % 3
    eng = BSPEngine(w, v, f, fm, part, mode=mode, devices=devices)
    states = eng.init_states()
    for p, s in enumerate(states):
        assert list(s.var_value.devices())[0] == devices[p]
    epochs = 2000
    states = eng.inference(states, jax.random.PRNGKey(1), epochs=epochs,
                           burn=100, sync_every=10)
    for p, s in enumerate(states):          # placement survives the loop
        assert list(s.var_value.devices())[0] == devices[p]
    marg = eng.marginals(states, epochs)
    err = np.abs(marg[:, :2] - exact[:, :2]).max()
    assert err < 0.07, err


def test_bsp_multi_device_learning():
    devices = jax.devices()[:2]
    if len(devices) < 2:
        pytest.skip("needs >= 2 devices")
    a, b, c = 0.8, -0.5, 0.4
    w, v, f, fm, dm, e = coin_model(1000, a, b, c, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    part = np.arange(len(v)) % 2
    eng = BSPEngine(w, v, f, fm, part, mode="values", domain_mask=dm,
                    devices=devices)
    states = eng.init_states()
    lp = LearnParams(regularization=2, reg_param=1e-4)
    states = eng.learn(states, jax.random.PRNGKey(0), epochs=100,
                       stepsize=0.1, decay=0.99, burn=5, lp=lp)
    got = eng.weights(states)
    assert got[0] == pytest.approx(a, abs=0.25)
    assert got[2] == pytest.approx(c, abs=0.25)


def test_traffic_accounting():
    w, v, f, fm = _random_graph(seed=2)
    part = np.arange(len(v)) % 2
    ev = BSPEngine(w, v, f, fm, part, mode="values")
    em = BSPEngine(w, v, f, fm, part, mode="messages")
    tv, tm = ev.sync_traffic(), em.sync_traffic()
    assert tv["boundary_values_per_sync"] > 0
    assert tm["message_floats_per_sync"] > 0
    # per-sync messages are bounded by (targets x kmax), independent of
    # factor arity — the compression PF/UFO were invented for
    assert tm["message_floats_per_sync"] <= 2 * len(v) * em.kmax


def test_bsp_plans_live_on_their_parts_device():
    """Every part's compiled plan arrays (padded layout included) sit on
    that part's device, so no part's sweep reads its plan from the
    coordinator's device."""
    devices = jax.devices()[:4]
    if len(devices) < 4:
        pytest.skip("needs >= 4 devices")
    w, v, f, fm, dm, e = coin_model(40, 0.3, -0.2, 0.4, evidence=False,
                                    weight_init=(0.3, -0.2, 0.4),
                                    fixed=True)
    part = np.arange(len(v)) % 4
    eng = BSPEngine(w, v, f, fm, part, domain_mask=dm, devices=devices)
    for p, sub in enumerate(eng.engines):
        assert sub.padded is not None
        arrays = list(sub.padded.values()) + [
            a for pd in sub.plans for a in pd.values()]
        assert all(a.devices() == {devices[p]} for a in arrays), p
