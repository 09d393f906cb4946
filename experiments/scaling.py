"""Chain/graph-axis scaling-efficiency experiment.

Analog of the reference's machine-scaling experiment (reference:
salt/src/experiment.py:8-26 — learning/inference wall time vs number of
minions), re-targeted at mesh axes: sweep (chains, graph) mesh shapes
over the available devices and report scaling efficiency of total
variable updates per second. On a CPU host run with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (tests do this
automatically); on a multi-GPU host it measures scaling over NVLink.

Usage: python experiments/scaling.py [out.tsv] [grid_n]
"""

from __future__ import annotations

import os
import sys
import time

# NSX_CPU_DEVICES=N forces an N-device virtual CPU platform (must run
# before jax initializes)
if os.environ.get("NSX_CPU_DEVICES"):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices",
                      int(os.environ["NSX_CPU_DEVICES"]))

import jax
import numpy as np

from numbskull_jax.compile import compile_graph
from numbskull_jax.models import ising_color_hint, ising_grid
from numbskull_jax.parallel.mesh import make_mesh
from numbskull_jax.parallel.sharded import ShardedGibbsEngine


def run(out_path="scaling.tsv", n=128, epochs=50):
    n_dev = len(jax.devices())
    w, v, f, fm, dm, e = ising_grid(n, n, weight=0.3)
    cg = compile_graph(w, v, f, fm, domain_mask=dm,
                       color_hint=ising_color_hint(n, n))

    shapes = []
    c = 1
    while c <= n_dev:
        shapes.append((c, n_dev // c))
        c *= 2
    rows = ["chains\tgraph\tepoch_ms\ttotal_updates_per_s\tefficiency"]
    base_ups = None
    for (nc, ng) in shapes:
        mesh = make_mesh(nc, ng)
        eng = ShardedGibbsEngine(cg, mesh)
        st = eng.init_state()
        st = eng.inference(st, jax.random.PRNGKey(0), epochs=2)
        np.asarray(st.count)
        t0 = time.perf_counter()
        st = eng.inference(st, jax.random.PRNGKey(1), epochs=epochs)
        np.asarray(st.count)
        dt = time.perf_counter() - t0
        ups = n * n * epochs * nc / dt   # chains multiply update count
        if base_ups is None:
            base_ups = ups
        eff = ups / base_ups
        rows.append(f"{nc}\t{ng}\t{1e3 * dt / epochs:.2f}\t{ups:.0f}\t"
                    f"{eff:.2f}")
        print(rows[-1], flush=True)
    with open(out_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    print("wrote", out_path)


if __name__ == "__main__":
    argv = sys.argv[1:]
    run(*argv[:1], *(int(a) for a in argv[1:2]))
