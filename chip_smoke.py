"""Smoke run of the main path on one GPU, through the entry points users call.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py            # one card: the phases below
    python3 chip_smoke.py --four     # only the multi-device path, four cards

One-card phases:

  cli_voting   the CLI (``numbskull_jax.numbskull.main``) on the reference's
               flagship deployment: grouped voting, degree 10, n_var=1.26M
               as the reference passes it (1.386M variables: one
               proposition per 10 voters), 30% evidence, one learnable
               weight, written as DeepDive files from ``--seed``; 20
               learning epochs, 50 inference epochs, 5 burn-in. Checks one ``vid value prob``
               line per variable with probabilities in [0, 1], and finite
               weights.
  golden       the engine's per-color potentials recomputed on the card for
               1,000 seeded random variables of that graph, against the
               float64 scalar oracle ``golden.potential`` at abs=1e-4. The
               state is a seeded probe, not the learned one: weight 0.7 and
               every value 1 with probability 0.93, so about half of the
               AND factors have ten of eleven arguments true and the
               potentials are 0 or 0.7. The phase fails unless at least a
               tenth of the compared potentials are far from zero, so an
               engine that computed nothing could not pass. The engine
               computes in float32 and its gather is a plain index, not a
               matrix product, so TF32 cannot enter.
  coin_learn   ``NumbSkull.loadFactorGraph`` + ``learning`` on the coin model
               at 400k variables: learned weights move toward (0.8, -0.5,
               0.4).
  coin_infer   ``NumbSkull`` inference on the coin model with those weights
               fixed: marginals, pooled over the copies, within 0.02 of
               ``coin_exact_marginal``.

``--four`` phases, all on four cards:

  four_cli_values, four_cli_messages
               the CLI with ``--parts 4`` on a 632 x 632 Ising grid
               (399,424 variables, EQUAL couplings of weight 0.25, no
               field, every chain started at 0), written as DeepDive files.
               The grid is one connected component, so every part cuts
               factors and the boundary exchange runs at each sync. With
               no field the exact marginal of every variable is 0.5 by
               symmetry. Checks that the sync ships boundary values, that
               the marginals pooled over all variables and over the
               boundary variables are within 0.01 of 0.5 and of the
               one-card ``GibbsEngine`` on the same graph, and that the
               two modes give different samples.
  four_sharded_1x4, four_sharded_4x1
               ``ShardedGibbsEngine`` on the coin model at 400k variables,
               against the one-card ``GibbsEngine`` and the exact coin
               marginals.

Each checks that its state spans four distinct devices.

Earlier lines report the device, the card's name and power limit, compile
and run time per phase and peak device memory. The last line is one JSON
object. The script exits non-zero, and prints no result line, when JAX finds
no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

VOTING_VARS = 1_260_000
VOTING_DEGREE = 10
COIN_COPIES = 200_000                 # 400k variables
COIN_TRUE = (0.8, -0.5, 0.4)
GRID_SIDE = 632                       # 399,424 variables
GRID_WEIGHT = 0.25                    # below the critical coupling 0.44
FOUR_TOL = 0.01                       # pooled marginals, --four phases
GOLDEN_SAMPLES = 1000
GOLDEN_ABS = 1e-4
GOLDEN_WEIGHT = 0.7                   # probe state: weight of every factor
GOLDEN_P_TRUE = 0.93                  # probe state: P(value = 1)
GOLDEN_MIN_LIVE = 0.1                 # share of potentials that must be
#                                       far from zero (|pot| >= weight/2)


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """The JAX device list, or SystemExit when the backend is not a GPU."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit("chip_smoke: JAX found no GPU (backend %r); "
                         "refusing to run" % backend)
    return jax.devices()


def result_line(devices) -> str:
    """The final JSON line for a run that passed on ``devices``."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def peak_memory_line() -> str:
    from numbskull_jax.observability import device_memory_stats
    parts = []
    for s in device_memory_stats():
        peak = s["peak_bytes_in_use"]
        parts.append("%s peak=%s" % (
            s["device"], "n/a" if peak is None else "%.3f GiB" % (
                peak / 2 ** 30)))
    return "peak device memory: " + "; ".join(parts)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---- one-card phases ------------------------------------------------------

def phase_cli_voting(workdir: str, seed: int, n_vars: int = VOTING_VARS,
                     degree: int = VOTING_DEGREE, learn: int = 20,
                     infer: int = 50, burn: int = 5) -> dict:
    """Write the voting graph as DeepDive files, run the CLI on it, check
    its output files; then time a warm repeat of learning and inference
    on the same engine (its compiled programs are cached)."""
    from numbskull_jax import dataloading
    from numbskull_jax.models import voting_grouped
    from numbskull_jax.numbskull import main
    from numbskull_jax.observability import metrics

    t0 = time.perf_counter()
    w, v, f, fm, dm, e = voting_grouped(n_vars, degree, weight=0.0,
                                        fixed=False, evidence_frac=0.3,
                                        seed=seed)
    gdir = os.path.join(workdir, "voting")
    dataloading.write_factor_graph_files(gdir, w, v, f, fm)
    gen_s = time.perf_counter() - t0

    out = os.path.join(workdir, "voting_out")
    mfile = os.path.join(workdir, "voting_metrics.json")
    metrics.reset()
    t0 = time.perf_counter()
    ns = main([gdir, "-l", str(learn), "-i", str(infer), "-b", str(burn),
               "-o", out, "--metrics_out", mfile, "-q",
               "--seed", str(seed)])
    cli_s = time.perf_counter() - t0
    with open(mfile) as fh:
        tm = json.load(fh)["timings"]
    learn_first = tm["learning.run_s"]["total_s"]
    infer_first = tm["inference.run_s"]["total_s"]

    with open(os.path.join(out, "inference_result.out.text")) as fh:
        rows = np.loadtxt(fh)
    check(rows.shape == (len(v), 3), "marginal file shape %s" %
          (rows.shape,))
    check((rows[:, 0] == np.arange(len(v))).all(), "one line per vid")
    check(((rows[:, 2] >= 0) & (rows[:, 2] <= 1)).all(),
          "probabilities in [0, 1]")
    with open(os.path.join(out, "inference_result.out.weights.text")) as fh:
        wts = np.atleast_2d(np.loadtxt(fh))
    check(wts.shape == (1, 2) and np.isfinite(wts[:, 1]).all(),
          "finite weights %s" % wts)

    fg = ns.factorGraphs[0]
    fg.learn(ns.burn_in, learn, ns.stepsize, ns.decay, ns.regularization,
             ns.reg_param, ns.truncation, grad_agg=ns.grad_agg)
    fg.inference(ns.burn_in, infer, sample_evidence=ns.sample_evidence)
    learn_warm, infer_warm = fg._last_learn_s, fg._last_infer_s
    V = len(v)
    return {
        "graph": (w, v, f, fm), "ns": ns,
        "report": {
            "n_vars": V, "n_factors": len(f), "colors": fg.cg.n_colors,
            "padded_path": fg.engine.padded is not None,
            "generate_and_write_s": gen_s, "cli_total_s": cli_s,
            "learn_first_s": learn_first, "learn_warm_s": learn_warm,
            "learn_compile_s": learn_first - learn_warm,
            "infer_first_s": infer_first, "infer_warm_s": infer_warm,
            "infer_compile_s": infer_first - infer_warm,
            "learn_var_updates_per_s": V * (learn + burn) / learn_warm,
            "infer_var_updates_per_s": V * (infer + burn) / infer_warm,
            "learned_weight": float(wts[0, 1]),
        }}


def _factors_of(fmap, factors):
    """(sorted_vid, factor_id): every edge's variable id, sorted, beside
    the id of the factor it belongs to."""
    arity = factors["arity"].astype(np.int64)
    edge_fid = np.repeat(np.arange(len(factors)), arity)
    vid = fmap["vid"].astype(np.int64)
    order = np.argsort(vid, kind="stable")
    return vid[order], edge_fid[order]


def golden_probe_state(eng, seed: int):
    """The engine's state with weight ``GOLDEN_WEIGHT`` everywhere and
    every value drawn 1 with probability ``GOLDEN_P_TRUE`` from ``seed``."""
    import dataclasses
    import jax.numpy as jnp

    st = eng.init_state()
    rng = np.random.default_rng(seed)
    x = (rng.random(st.var_value.shape[0]) < GOLDEN_P_TRUE).astype(np.int32)
    return dataclasses.replace(
        st, var_value=jnp.asarray(x),
        weight_value=jnp.full_like(st.weight_value, GOLDEN_WEIGHT))


def phase_golden(graph, eng, seed: int, n_samples: int = GOLDEN_SAMPLES
                 ) -> dict:
    """Padded-path potentials on the device vs the float64 scalar oracle
    for ``n_samples`` seeded random variables, at the probe state."""
    import jax
    from numbskull_jax import golden

    w, v, f, fm = graph
    check(eng.padded is not None, "padded path active")
    st = golden_probe_state(eng, seed)
    t0 = time.perf_counter()
    pot = jax.block_until_ready(eng.padded_potentials(st))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pot = jax.block_until_ready(eng.padded_potentials(st))
    warm_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)
    vids = rng.choice(len(v), size=min(n_samples, len(v)), replace=False)
    pot = np.asarray(pot[vids], np.float64)
    x = np.asarray(st.var_value, np.int64)
    wv = np.asarray(st.weight_value, np.float64)
    svid, sfid = _factors_of(fm, f)
    worst, live, total = 0.0, 0, 0
    for i, vid in enumerate(vids):
        lo, hi = np.searchsorted(svid, [vid, vid + 1])
        sub = f[np.unique(sfid[lo:hi])]    # only factors touching vid
        for k in range(int(v["cardinality"][vid])):
            want = golden.potential(v, sub, fm, wv, int(vid), k, x)
            err = abs(pot[i, k] - want)
            worst = max(worst, err)
            live += abs(want) >= GOLDEN_WEIGHT / 2
            total += 1
            check(err <= GOLDEN_ABS, "potential of var %d at %d: %r vs "
                  "golden %r" % (vid, k, pot[i, k], want))
    check(live >= GOLDEN_MIN_LIVE * total,
          "only %d of %d oracle potentials are far from zero" % (live,
                                                                 total))
    return {"samples": len(vids), "potentials": total, "live": live,
            "max_abs_err": worst, "first_s": first_s, "warm_s": warm_s,
            "compile_s": first_s - warm_s}


def _coin_ns(epochs_learn: int, epochs_infer: int, seed: int, **kw):
    from numbskull_jax.numbskull import NumbSkull
    return NumbSkull(n_learning_epoch=epochs_learn,
                     n_inference_epoch=epochs_infer, quiet=True, seed=seed,
                     **kw)


def phase_coin_learn(seed: int, copies: int = COIN_COPIES,
                     epochs: int = 100) -> dict:
    """Weight learning through the library on 2*copies coin variables."""
    from numbskull_jax.models import coin_model

    args = coin_model(copies, *COIN_TRUE, evidence=True,
                      weight_init=(0.0, 0.0, 0.0), fixed=False, seed=seed)
    ns = _coin_ns(epochs, 0, seed, stepsize=0.05, decay=0.99,
                  reg_param=1e-4)
    ns.loadFactorGraph(*args)
    ns.learning(out=False)
    fg = ns.factorGraphs[0]
    wv = fg.getWeights()
    first_s = fg._last_learn_s
    check(bool(np.isfinite(wv).all()), "finite weights %s" % wv)
    # the direction check bench.py has always used
    check(wv[0] > 0.2 and wv[1] < -0.1 and wv[2] > 0.1,
          "learned weights %s move toward %s" % (wv, COIN_TRUE))
    fg.learn(0, epochs, 0.05, 0.99, 2, 1e-4, 1)
    warm_s = fg._last_learn_s
    return {"n_vars": 2 * copies, "epochs": epochs,
            "weights": [float(x) for x in wv],
            "first_s": first_s, "warm_s": warm_s,
            "compile_s": first_s - warm_s,
            "var_updates_per_s": 2 * copies * epochs / warm_s}


def coin_pooled(marg: np.ndarray) -> tuple[float, float]:
    """P(x1=1), P(x2=1) pooled over the copies of a coin marginal."""
    return float(marg[0::2, 1].mean()), float(marg[1::2, 1].mean())


def coin_exact_pooled() -> tuple[float, float]:
    from numbskull_jax.models import coin_exact_marginal
    ex = coin_exact_marginal(*COIN_TRUE)
    return float(ex[2] + ex[3]), float(ex[1] + ex[3])


def phase_coin_infer(seed: int, copies: int = COIN_COPIES,
                     epochs: int = 1000, burn: int = 50) -> dict:
    """Inference through the library with the true weights fixed."""
    from numbskull_jax.models import coin_model

    args = coin_model(copies, *COIN_TRUE, evidence=False,
                      weight_init=COIN_TRUE, fixed=True, seed=seed)
    ns = _coin_ns(0, epochs, seed, burn_in=burn)
    ns.loadFactorGraph(*args)
    ns.inference(out=False)
    fg = ns.factorGraphs[0]
    first_s = fg._last_infer_s
    got = coin_pooled(fg.full_marginals(epochs))
    want = coin_exact_pooled()
    check(all(abs(g - x) <= 0.02 for g, x in zip(got, want)),
          "pooled marginals %s vs exact %s" % (got, want))
    fg.inference(burn, epochs, sample_evidence=True)
    warm_s = fg._last_infer_s
    return {"n_vars": 2 * copies, "epochs": epochs, "pooled": got,
            "exact": want, "first_s": first_s, "warm_s": warm_s,
            "compile_s": first_s - warm_s,
            "var_updates_per_s": 2 * copies * (epochs + burn) / warm_s}


def run_one_card(seed: int, workdir: str) -> None:
    cli = phase_cli_voting(workdir, seed)
    log("phase cli_voting: %s" % json.dumps(cli["report"]))
    log("phase golden: %s" % json.dumps(phase_golden(
        cli["graph"], cli["ns"].factorGraphs[0].engine, seed)))
    del cli
    log("phase coin_learn: %s" % json.dumps(phase_coin_learn(seed)))
    log("phase coin_infer: %s" % json.dumps(phase_coin_infer(seed)))


# ---- four-card phases -----------------------------------------------------

def _one_card_reference(args, epochs: int, burn: int, seed: int):
    """Pooled coin marginals of the one-card GibbsEngine."""
    import jax
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.ops import GibbsEngine

    w, v, f, fm, dm, e = args
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm,
                                    seed=seed))
    st = eng.inference(eng.init_state(), jax.random.PRNGKey(seed), epochs,
                       burn=burn)
    return coin_pooled(np.asarray(st.count, np.float64) / epochs)


def _compare(name: str, got, ref, exact, tol: float = 0.02) -> dict:
    check(all(abs(g - x) <= tol for g, x in zip(got, exact)),
          "%s: pooled %s vs exact %s" % (name, got, exact))
    check(all(abs(g - r) <= tol for g, r in zip(got, ref)),
          "%s: pooled %s vs one-card engine %s" % (name, got, ref))
    return {"pooled": got, "one_card": ref, "exact": exact}


def _grid_graph(side: int):
    """The --four BSP graph: an Ising grid with every chain at 0."""
    from numbskull_jax.models import ising_grid

    w, v, f, fm, dm, e = ising_grid(side, side, weight=GRID_WEIGHT)
    v["initialValue"] = 0
    return w, v, f, fm, dm


def boundary_mask(fmap, factors, part: np.ndarray) -> np.ndarray:
    """Variables that share a factor with a variable of another part."""
    arity = factors["arity"].astype(np.int64)
    edge_fid = np.repeat(np.arange(len(factors)), arity)
    vid = fmap["vid"].astype(np.int64)
    lo = np.full(len(factors), np.iinfo(np.int64).max)
    hi = np.full(len(factors), -1)
    np.minimum.at(lo, edge_fid, part[vid])
    np.maximum.at(hi, edge_fid, part[vid])
    out = np.zeros(len(part), bool)
    out[vid[(lo != hi)[edge_fid]]] = True
    return out


def _grid_pooled(p1: np.ndarray, bmask: np.ndarray) -> dict:
    return {"all": float(p1.mean()), "boundary": float(p1[bmask].mean())}


def phase_four_cli(workdir: str, mode: str, seed: int, side: int,
                   epochs: int, burn: int) -> dict:
    """The CLI with --parts 4 on the grid; returns the report and P(x=1)
    of every variable."""
    from numbskull_jax import dataloading
    from numbskull_jax.numbskull import main

    w, v, f, fm, dm = _grid_graph(side)
    gdir = os.path.join(workdir, "grid")
    if not os.path.isdir(gdir):
        dataloading.write_factor_graph_files(gdir, w, v, f, fm)
    out = os.path.join(workdir, "grid_out_" + mode)
    t0 = time.perf_counter()
    ns = main([gdir, "-i", str(epochs), "-b", str(burn), "-o", out, "-q",
               "--seed", str(seed), "--parts", "4", "--dist_mode", mode])
    total_s = time.perf_counter() - t0
    res = ns.distributed
    check(res["mode"] == mode, "mode %s ran as %s" % (mode, res["mode"]))
    check(len(res["devices"]) == 4 and len(set(res["devices"])) == 4,
          "part states on four distinct devices: %s" % res["devices"])
    check(res["traffic"]["boundary_values_per_sync"] > 0,
          "the partition cuts no factor: %s" % res["traffic"])
    rows = np.loadtxt(os.path.join(out, "inference_result.out.text"))
    check(rows.shape == (len(v), 3), "marginal file shape")
    bmask = boundary_mask(fm, f, np.asarray(res["part"]))
    rep = {"pooled": _grid_pooled(rows[:, 2], bmask),
           "boundary_vars": int(bmask.sum()), "traffic": res["traffic"],
           "devices": res["devices"], "partition": res["partition"],
           "cli_total_s": total_s, "inference_s": res["inference_s"]}
    return rep, rows[:, 2], bmask


def _grid_one_card(side: int, epochs: int, burn: int, seed: int):
    """P(x=1) of every grid variable from the one-card GibbsEngine."""
    import jax
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.ops import GibbsEngine

    w, v, f, fm, dm = _grid_graph(side)
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm, seed=seed))
    st = eng.inference(eng.init_state(), jax.random.PRNGKey(seed), epochs,
                       burn=burn)
    return np.asarray(st.count[:, 1], np.float64) / epochs


def run_four_bsp(seed: int, workdir: str, side: int = GRID_SIDE,
                 epochs: int = 500, burn: int = 50,
                 tol: float = FOUR_TOL) -> None:
    ref = _grid_one_card(side, epochs, burn, seed)
    runs = {}
    for mode in ("values", "messages"):
        rep, p1, bmask = phase_four_cli(workdir, mode, seed, side, epochs,
                                        burn)
        one = _grid_pooled(ref, bmask)
        for k, got in rep["pooled"].items():
            check(abs(got - 0.5) <= tol,
                  "%s: pooled %s %r vs exact 0.5" % (mode, k, got))
            check(abs(got - one[k]) <= tol,
                  "%s: pooled %s %r vs one-card engine %r" % (
                      mode, k, got, one[k]))
        rep["one_card"], rep["exact"] = one, 0.5
        runs[mode] = p1
        log("phase four_cli_%s: %s" % (mode, json.dumps(rep)))
    check(not np.array_equal(runs["values"], runs["messages"]),
          "values and messages modes gave identical samples")


def phase_four_sharded(shape, seed: int, ref, exact, copies: int,
                       epochs: int, burn: int) -> dict:
    import jax
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.models import coin_model
    from numbskull_jax.parallel.mesh import make_mesh
    from numbskull_jax.parallel.sharded import ShardedGibbsEngine

    w, v, f, fm, dm, e = coin_model(copies, *COIN_TRUE, evidence=False,
                                    weight_init=COIN_TRUE, fixed=True,
                                    seed=seed)
    cg = compile_graph(w, v, f, fm, domain_mask=dm, seed=seed)
    eng = ShardedGibbsEngine(cg, make_mesh(*shape))
    st = eng.init_state()
    t0 = time.perf_counter()
    st = jax.block_until_ready(eng.inference(
        st, jax.random.PRNGKey(seed), epochs, burn=burn))
    first_s = time.perf_counter() - t0
    state_devs = st.count.sharding.device_set
    plan_devs = set().union(*(a.sharding.device_set
                              for pd in eng.plans for a in pd.values()))
    check(len(state_devs) == 4, "state on %d devices" % len(state_devs))
    check(len(plan_devs) == 4, "plans on %d devices" % len(plan_devs))
    rep = _compare("sharded %s" % (shape,),
                   coin_pooled(eng.marginals(st, epochs)), ref, exact)
    rep.update(mesh=list(shape), first_s=first_s,
               state_devices=sorted(str(d) for d in state_devs))
    return rep


def run_four_cards(devices, seed: int, workdir: str) -> None:
    from numbskull_jax.models import coin_model

    check(len(devices) >= 4, "four devices, found %d" % len(devices))
    run_four_bsp(seed, workdir)
    copies, epochs, burn = COIN_COPIES, 500, 50
    args = coin_model(copies, *COIN_TRUE, evidence=False,
                      weight_init=COIN_TRUE, fixed=True, seed=seed)
    exact = coin_exact_pooled()
    ref = _one_card_reference(args, epochs, burn, seed)
    log("phase four_one_card_reference: %s" % json.dumps(
        {"pooled": ref, "exact": exact}))
    for shape in ((1, 4), (4, 1)):
        log("phase four_sharded_%dx%d: %s" % (shape + (json.dumps(
            phase_four_sharded(shape, seed, ref, exact, copies, epochs,
                               burn)),)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device path, on four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devices = require_gpu()
    log("device: %s x%d (%s)" % (devices[0].device_kind, len(devices),
                                 devices[0].platform))
    from numbskull_jax.benchutil import card_name_and_power_limit
    log("nvidia-smi name, power.limit: %s" % card_name_and_power_limit())
    devices = devices[:4] if args.four else devices[:1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.four:
            run_four_cards(devices, args.seed, workdir)
        else:
            run_one_card(args.seed, workdir)
    log(peak_memory_line())
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
