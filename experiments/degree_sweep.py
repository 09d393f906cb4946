"""Degree-scaling experiment: throughput vs factor degree.

The reference's flagship scaling experiment
(reference: salt/src/experiment_intro_degree.py:9-88 — 1.26M variables,
degree 1..50, copies = n_vars/degree disjoint voting groups of one
proposition + degree voters under a single AND factor;
experiments/intro/generate.py) through the XLA engine. Each rate is the
best of three timed runs ending in block_until_ready
(numbskull_jax/benchutil.py); compiles go through the on-disk plan
cache (NSX_PLAN_CACHE; a second run's compile_s is ~0).

Usage: PYTHONPATH=. python experiments/degree_sweep.py [out.tsv] [n_vars]
"""

from __future__ import annotations

import os
import sys
import time

import jax

from numbskull_jax.benchutil import timed_rate
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import voting_grouped
from numbskull_jax.ops import GibbsEngine


def run(out_path="degree_sweep.tsv", n_vars=1_260_000,
        degrees=(1, 2, 5, 10, 20, 35, 50)):
    cache = os.environ.get("NSX_PLAN_CACHE")      # 2nd run: ~0s
    rows = ["degree\tn_vars\tn_colors\tcompile_s\tepoch_ms\t"
            "updates_per_s"]
    for degree in degrees:
        args = voting_grouped(n_vars, degree, weight=0.3, seed=1)
        w, v, f, fm, dm, e = args
        V = len(v)
        t0 = time.perf_counter()
        cg = compile_graph(w, v, f, fm, domain_mask=dm,
                           cache=cache or None)
        compile_s = time.perf_counter() - t0

        eng = GibbsEngine(cg)
        st = eng.init_state()
        key = jax.random.PRNGKey(1)
        ups, per = timed_rate(
            lambda ep: eng.inference(st, key, epochs=ep).count, V, 200)
        rows.append(f"{degree}\t{V}\t{cg.n_colors}\t"
                    f"{compile_s:.2f}\t{1e3 * per:.2f}\t{ups:.0f}")
        print(rows[-1], flush=True)
    with open(out_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    print("wrote", out_path)


if __name__ == "__main__":
    argv = sys.argv[1:]
    run(*argv[:1], *(int(a) for a in argv[1:2]))
