"""Timed multi-process SPMD program for experiments/multiproc_scaling.py.

One OS process of an N-process Gloo cluster (jax.distributed), owning
DEVS virtual CPU devices of a fixed-size global mesh. Runs the
ShardedGibbsEngine inference epoch loop on a fixed graph and reports
the measured epochs/s (coordinator writes OUT.npz). The graph and the
total device count are FIXED across topologies, so rate(nproc) /
rate(1 process) isolates what crossing process boundaries costs the
collectives (the reference's machine-scaling experiment, salt/src/
experiment.py:8-26, measured on live clusters; on one box the compute
is constant by construction).

Usage: python _multiproc_prog.py PROC NPROC DEVS PORT OUT N_VARS EPOCHS
"""

import os
import sys
import time


def main(proc: int, nproc: int, devs: int, port: int, out: str,
         n_copies: int, epochs: int):
    os.environ["XLA_FLAGS"] = \
        "--xla_force_host_platform_device_count=%d" % devs
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

    from numbskull_jax.parallel import multihost
    multihost.initialize(coordinator_address="127.0.0.1:%d" % port,
                         num_processes=nproc, process_id=proc)
    assert jax.process_count() == nproc
    import numpy as np

    from numbskull_jax.compile import compile_graph
    from numbskull_jax.models import coin_model
    from numbskull_jax.parallel.sharded import ShardedGibbsEngine

    w, v, f, fm, dm, e = coin_model(n_copies, 0.5, -0.4, 0.3,
                                    evidence=False,
                                    weight_init=(0.5, -0.4, 0.3),
                                    fixed=True, seed=7)
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    mesh = multihost.global_mesh(n_chains=1)
    eng = ShardedGibbsEngine(cg, mesh)
    st = eng.init_state()
    # warm-up compiles the epoch loop (donated-state second call too)
    st = eng.inference(st, jax.random.PRNGKey(0), epochs=2, burn=0)
    st = eng.inference(st, jax.random.PRNGKey(1), epochs=2, burn=0)
    jax.block_until_ready(st.count)
    t0 = time.perf_counter()
    st = eng.inference(st, jax.random.PRNGKey(2), epochs=epochs, burn=0)
    jax.block_until_ready(st.count)
    dt = time.perf_counter() - t0
    if multihost.is_coordinator():
        np.savez(out, seconds=dt, epochs=epochs, n_vars=len(v),
                 nproc=nproc, n_devices=len(jax.devices()))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         int(sys.argv[4]), sys.argv[5], int(sys.argv[6]),
         int(sys.argv[7]))
