"""Benchmark: Gibbs variable updates/s of the XLA engines on one device.

Prints the device and the card's name and power limit, then ONE JSON
line of rates. Every rate is the best of three timed runs at a fixed
epoch count, each waited on with ``block_until_ready``, after one
untimed run that compiles.

Cases:
  xla_stencil_ups_2048            lattice engine (ops/stencil.py), 2048²
  general_engine_ups_256          NumbSkull FactorGraph on a 256² Ising
                                  graph without a color hint (what a
                                  user's general graph gets)
  xla_oracle_ups_256              GibbsEngine on the 256² grid with the
                                  lattice color hint
  categorical_card64_ups          Potts grid, cardinality 64, 128²
  voting_deg10_ups                grouped voting, degree 10, 200k vars
  voting_deg50_ups                grouped voting, degree 50, 204k vars
  learn_var_updates_per_s[_400k]  coin-model learning, 40k and 400k vars
  learn_voting_deg10_var_updates_per_s  voting learning, 200k vars

Baseline: the reference (HazyResearch/numbskull) publishes no numbers
(BASELINE.md); its numba CSR Gibbs sustains ~1e7 variable updates/s per
core on low-degree boolean graphs. vs_baseline = ours / 1e7.

Run on the GPU: python bench.py
"""

from __future__ import annotations

import json

import jax

from numbskull_jax.benchutil import card_name_and_power_limit, timed_rate

NUMBA_CPU_BASELINE = 1.0e7  # updates/s, single-core numba CSR Gibbs


def _infer_rate(cg, epochs):
    from numbskull_jax.ops import GibbsEngine

    eng = GibbsEngine(cg)
    st = eng.init_state()
    key = jax.random.PRNGKey(1)
    ups, _ = timed_rate(lambda ep: eng.inference(st, key, epochs=ep).count,
                        cg.n_vars, epochs)
    return ups


def _bench_xla_grid(n: int):
    from numbskull_jax.ops.stencil import GridGibbsEngine

    eng = GridGibbsEngine(n, n, 0.3)
    st = eng.init_state()
    key = jax.random.PRNGKey(1)
    ups, _ = timed_rate(lambda ep: eng.inference(st, key, epochs=ep).count,
                        n * n, 300)
    return ups


def _bench_general(n: int):
    """GibbsEngine on the lattice with its 2-color hint."""
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.models import ising_color_hint, ising_grid

    w, v, f, fm, dm, e = ising_grid(n, n, weight=0.3)
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, n))
    return _infer_rate(cg, 1000)


def _bench_auto(n: int):
    """What a USER gets for a general (un-hinted) graph through the
    public API."""
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.models import ising_grid
    from numbskull_jax.numbskull import FactorGraph

    w, v, f, fm, dm, e = ising_grid(n, n, weight=0.3)
    cg = compile_graph(w, v, f, fm, domain_mask=dm)   # no hint: general
    fg = FactorGraph(cg, 0)

    def run(ep):
        fg.inference(0, ep, sample_evidence=True)
        return fg.state.count

    ups, _ = timed_rate(run, n * n, 1000)
    return ups


def _bench_potts_card64(n: int):
    """Cardinality-64 categorical (Potts) grid. The reference's draw
    loops over all 64 candidate values per variable
    (inference.py:36-52)."""
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.models import ising_color_hint, potts_grid

    w, v, f, fm, dm, e = potts_grid(n, n, card=64, weight=0.2)
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, n))
    return _infer_rate(cg, 200)


def _bench_voting(n_vars: int, degree: int):
    """The reference's flagship degree experiment family (grouped
    voting: n_vars//degree disjoint AND factors of arity degree+1;
    salt/src/experiment_intro_degree.py)."""
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.models import voting_grouped

    w, v, f, fm, dm, e = voting_grouped(n_vars, degree, weight=0.3)
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    return _infer_rate(cg, 500)


def _learn_rate(args, epochs, stepsize):
    """(var-updates/s, weights): dual-chain SGD through GibbsEngine.learn;
    each variable counts once per epoch."""
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.ops import GibbsEngine, LearnParams

    w, v, f, fm, dm, e = args
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm))
    st = eng.init_state()
    key = jax.random.PRNGKey(1)
    lp = LearnParams(regularization=2, reg_param=1e-4)
    out = {}

    def run(ep):
        out["st"] = eng.learn(st, key, epochs=ep, stepsize=stepsize,
                              decay=0.99, lp=lp)
        return out["st"].weight_value

    vups, _ = timed_rate(run, len(v), epochs)
    return vups, jax.device_get(out["st"].weight_value)


def _bench_learning(copies: int):
    """Coin-model learning (reference analog: learnthread,
    learning.py:12-31); weights should move toward (0.8, -0.5, 0.4)."""
    from numbskull_jax.models import coin_model

    args = coin_model(copies, 0.8, -0.5, 0.4, evidence=True,
                      weight_init=(0.0, 0.0, 0.0), fixed=False, seed=3)
    vups, wv = _learn_rate(args, 100, 0.05)
    ok = wv[0] > 0.2 and wv[1] < -0.1 and wv[2] > 0.1
    return vups, bool(ok)


def _bench_learning_voting(n_vars: int, degree: int):
    """Dual-chain SGD on the grouped-voting family — the graphs the
    reference LEARNED on across its cluster
    (salt/src/experiment_intro_degree.py:29-88). 30% evidence voters,
    learnable AND weight."""
    from numbskull_jax.models import voting_grouped

    args = voting_grouped(n_vars, degree, weight=0.0, fixed=False,
                          evidence_frac=0.3, seed=2)
    vups, _ = _learn_rate(args, 50, 0.01)
    return vups


def main():
    if jax.default_backend() != "gpu":
        raise SystemExit("bench.py measures a GPU; JAX found backend %r"
                         % jax.default_backend())
    dev = jax.devices()[0]
    print("device: %s x%d (%s)" % (dev.device_kind, len(jax.devices()),
                                   dev.platform), flush=True)
    print("nvidia-smi name, power.limit: %s" % card_name_and_power_limit(),
          flush=True)
    learn_vups, learn_ok = _bench_learning(20_000)
    learn_vups_400k, _ = _bench_learning(200_000)
    general = _bench_auto(256)
    result = {
        "metric": "general_engine_ups_256",
        "value": general,
        "unit": "variable updates/s",
        "vs_baseline": general / NUMBA_CPU_BASELINE,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "xla_stencil_ups_2048": _bench_xla_grid(2048),
        "xla_oracle_ups_256": _bench_general(256),
        "categorical_card64_ups": _bench_potts_card64(128),
        "voting_deg10_ups": _bench_voting(200_000, 10),
        "voting_deg50_ups": _bench_voting(204_000, 50),
        "learn_var_updates_per_s": learn_vups,
        "learn_recovers_weights": learn_ok,
        "learn_var_updates_per_s_400k": learn_vups_400k,
        "learn_voting_deg10_var_updates_per_s":
            _bench_learning_voting(200_000, 10),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
