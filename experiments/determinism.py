"""Is a run with one seed bit-for-bit repeatable on this device?

Runs each case twice in one process with the same seed and compares the
results bitwise:

  learn_coin        NumbSkull learning, coin model, 40k variables
  learn_voting      NumbSkull learning, grouped voting deg 10, 200k vars
  infer_padded      GibbsEngine inference on the padded path (no scatter)
  infer_flat        GibbsEngine inference on the flat path (segment_sum)
  cli_resume_infer  CLI inference with --checkpoint every 40 epochs vs one
                    uninterrupted run (the checkpoint tests' claim)
  cli_resume_learn  CLI learning interrupted at 80 epochs and resumed to
                    120 vs an uninterrupted chunked run
  proc_resume_learn the same, with every CLI run in a new process (a
                    fresh JAX runtime; compiled programs come from the
                    persistent compile cache or are compiled anew)
  proc_resume_infer CLI inference interrupted at 80 epochs and resumed to
                    120 in a new process vs an uninterrupted run

The new-process cases run first, one process at a time, before this
process touches the device: each JAX process reserves most of the card.
Learning and flat inference reduce with float scatter-adds
(``segment_sum``); were they lowered to atomics in no fixed order, these
cases would differ in the last bits. Prints one JSON line per case and
writes them to the optional output path.

Run: PYTHONPATH=. python experiments/determinism.py [out.jsonl]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np

from numbskull_jax import dataloading
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import coin_model, ising_grid, voting_grouped
from numbskull_jax.numbskull import NumbSkull, main as cli
from numbskull_jax.ops import GibbsEngine


def learn_weights(args, epochs, seed=0):
    ns = NumbSkull(n_learning_epoch=epochs, quiet=True, seed=seed,
                   stepsize=0.05, decay=0.99, reg_param=1e-4)
    ns.loadFactorGraph(*args)
    ns.learning(out=False)
    return ns.factorGraphs[0].getWeights()


def infer_counts(args, padded, epochs=200, seed=0):
    w, v, f, fm, dm, e = args
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm),
                      padded=padded)
    st = eng.inference(eng.init_state(), jax.random.PRNGKey(seed), epochs,
                       burn=10)
    return np.asarray(st.count)


def cli_out(argv, name):
    cli(argv + ["-q"])
    out = argv[argv.index("-o") + 1]
    return open(os.path.join(out, name), "rb").read()


def resume_cases(tmp):
    args = coin_model(20_000, 0.8, -0.5, 0.4, evidence=True,
                      weight_init=(0.0, 0.0, 0.0), fixed=False, seed=3)
    gdir = os.path.join(tmp, "g")
    dataloading.write_factor_graph_files(gdir, *args[:4])
    base = [gdir, "--seed", "5"]
    marg = "inference_result.out.text"
    wts = "inference_result.out.weights.text"
    a = cli_out(base + ["-i", "120", "-o", os.path.join(tmp, "a")], marg)
    b = cli_out(base + ["-i", "120", "-o", os.path.join(tmp, "b"),
                        "--checkpoint", os.path.join(tmp, "ck1.npz"),
                        "--checkpoint_every", "40"], marg)
    yield "cli_resume_infer", a == b
    ck = os.path.join(tmp, "ck2.npz")
    full = cli_out(base + ["-l", "120", "-i", "5",
                           "-o", os.path.join(tmp, "c"),
                           "--checkpoint", os.path.join(tmp, "ck3.npz"),
                           "--checkpoint_every", "40"], wts)
    cli_out(base + ["-l", "80", "-i", "5", "-o", os.path.join(tmp, "d"),
                    "--checkpoint", ck, "--checkpoint_every", "40"], wts)
    resumed = cli_out(base + ["-l", "120", "-i", "5",
                              "-o", os.path.join(tmp, "e"),
                              "--checkpoint", ck, "--checkpoint_every",
                              "40"], wts)
    yield "cli_resume_learn", full == resumed


def proc_out(argv, name):
    """Run the CLI in a new process; the bytes of one output file."""
    subprocess.run([sys.executable, "-m", "numbskull_jax"] + argv + ["-q"],
                   check=True)
    out = argv[argv.index("-o") + 1]
    return open(os.path.join(out, name), "rb").read()


def process_resume_cases(tmp):
    args = coin_model(20_000, 0.8, -0.5, 0.4, evidence=True,
                      weight_init=(0.0, 0.0, 0.0), fixed=False, seed=3)
    gdir = os.path.join(tmp, "g")
    dataloading.write_factor_graph_files(gdir, *args[:4])
    base = [gdir, "--seed", "5", "--checkpoint_every", "40"]
    wts = "inference_result.out.weights.text"
    marg = "inference_result.out.text"

    def run(learn, infer, ck, out, name):
        return proc_out(base + ["-l", str(learn), "-i", str(infer),
                                "--checkpoint", os.path.join(tmp, ck),
                                "-o", os.path.join(tmp, out)], name)

    full = run(120, 5, "pl_full.npz", "pl_a", wts)
    run(80, 5, "pl_cut.npz", "pl_b", wts)
    yield "proc_resume_learn", full == run(120, 5, "pl_cut.npz", "pl_c",
                                           wts)
    full = run(0, 120, "pi_full.npz", "pi_a", marg)
    run(0, 80, "pi_cut.npz", "pi_b", marg)
    yield "proc_resume_infer", full == run(0, 120, "pi_cut.npz", "pi_c",
                                           marg)


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else ""
    with tempfile.TemporaryDirectory() as tmp:
        first = list(process_resume_cases(tmp))
    dev = jax.devices()[0]
    coin = coin_model(20_000, 0.8, -0.5, 0.4, evidence=True,
                      weight_init=(0.0, 0.0, 0.0), fixed=False, seed=3)
    voting = voting_grouped(200_000, 10, weight=0.0, fixed=False,
                            evidence_frac=0.3, seed=2)
    ising = ising_grid(256, 256, weight=0.3)
    cases = []

    def record(name, same, detail=None):
        rec = {"case": name, "bit_identical": bool(same),
               "device_kind": dev.device_kind}
        if detail is not None:
            rec["detail"] = detail
        print(json.dumps(rec), flush=True)
        cases.append(rec)

    for name, args, ep in (("learn_coin", coin, 200),
                           ("learn_voting", voting, 50)):
        w1, w2 = learn_weights(args, ep), learn_weights(args, ep)
        record(name, np.array_equal(w1, w2),
               {"run1": w1.tolist(), "run2": w2.tolist(),
                "max_abs_diff": float(np.abs(w1 - w2).max())})
    for name, padded in (("infer_padded", None), ("infer_flat", False)):
        c1, c2 = infer_counts(ising, padded), infer_counts(ising, padded)
        record(name, np.array_equal(c1, c2),
               {"differing_tallies": int((c1 != c2).sum())})
    with tempfile.TemporaryDirectory() as tmp:
        for name, same in resume_cases(tmp):
            record(name, same)
    for name, same in first:
        record(name, same)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as fh:
            for rec in cases:
                fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
