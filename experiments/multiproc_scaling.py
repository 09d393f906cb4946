"""Multi-PROCESS topology sweep: the machine-scaling experiment analog.

The reference measured learning wall time as machines were added to a
salt cluster (salt/src/experiment.py:8-26, raiders cluster). This box
has ONE core, so adding processes cannot add compute; what it CAN
measure is the cost of crossing process boundaries: a FIXED graph on a
FIXED 4-device global mesh, with the devices owned by 1, 2, or 4
Gloo-joined OS processes (jax.distributed). The SPMD program is
bit-identical across topologies (proved by tests/test_multihost.py);
the rate ratio to the 1-process run is the process-boundary overhead
of the per-color collectives. A BSPEngine row (1 process, 4 devices,
stale-halo parts semantics) is included for comparison with the
exact-sync engine.

Usage: python experiments/multiproc_scaling.py [out.tsv] [n_copies] [epochs]
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

PROG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "_multiproc_prog.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_topology(nproc: int, devs_per_proc: int, n_copies: int,
                 epochs: int, out: str):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, PROG, str(p), str(nproc), str(devs_per_proc),
         str(port), out, str(n_copies), str(epochs)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(nproc)]
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(o.decode()[-2000:])
    return np.load(out)


def bsp_row(n_copies: int, epochs: int):
    """BSP stale-halo engine on the same graph, 1 process x 4 devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")

    from numbskull_jax.compile import compile_graph  # noqa: F401
    from numbskull_jax.models import coin_model
    from numbskull_jax.parallel.bsp import BSPEngine

    w, v, f, fm, dm, e = coin_model(n_copies, 0.5, -0.4, 0.3,
                                    evidence=False,
                                    weight_init=(0.5, -0.4, 0.3),
                                    fixed=True, seed=7)
    part = np.arange(len(v)) % 4
    bsp = BSPEngine(w, v, f, fm, part, mode="messages", domain_mask=dm,
                    devices=jax.devices()[:4])
    states = bsp.init_states()
    states = bsp.inference(states, jax.random.PRNGKey(0), epochs=2)
    jax.block_until_ready(states[0].count)
    t0 = time.perf_counter()
    states = bsp.inference(states, jax.random.PRNGKey(2), epochs=epochs)
    jax.block_until_ready(states[0].count)
    dt = time.perf_counter() - t0
    return len(v) * epochs / dt, dt / epochs


def run(out_path="multiproc_scaling.tsv", n_copies=4096, epochs=60):
    rows = ["engine\tnproc\tdevs_per_proc\tn_vars\tepoch_ms\t"
            "updates_per_s\tvs_1proc"]
    base = None
    for nproc, devs in ((1, 4), (2, 2), (4, 1)):
        r = run_topology(nproc, devs, n_copies, epochs,
                         "/tmp/mp_%d.npz" % nproc)
        rate = float(r["n_vars"]) * epochs / float(r["seconds"])
        per = float(r["seconds"]) / epochs
        base = rate if base is None else base
        rows.append("sharded\t%d\t%d\t%d\t%.2f\t%.3e\t%.2f" %
                    (nproc, devs, int(r["n_vars"]), 1e3 * per, rate,
                     rate / base))
        print(rows[-1], flush=True)
    rate, per = bsp_row(n_copies, epochs)
    rows.append("bsp\t1\t4\t%d\t%.2f\t%.3e\t%.2f" %
                (2 * n_copies, 1e3 * per, rate, rate / base))
    print(rows[-1], flush=True)
    with open(out_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    print("wrote", out_path)


if __name__ == "__main__":
    argv = sys.argv[1:]
    run(*argv[:1], *(int(a) for a in argv[1:3]))
