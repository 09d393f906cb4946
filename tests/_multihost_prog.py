"""Multi-PROCESS distributed program driven by tests/test_multihost.py.

The reference's multi-machine execution was only ever validated on live
salt clusters (SURVEY.md §4); this program is the single-box stand-in:
N OS processes, each owning a slice of virtual CPU devices, joined by
jax.distributed into one global mesh, running the SAME SPMD
ShardedGibbsEngine program a multi-host GPU job would run (multihost.initialize ->
multihost.global_mesh -> collectives over the joint mesh; reference
analog: salt/src/numbskull_master.py:133-233 epoch loop +
setup_scripts/start_minions.sh cluster bring-up).

Usage: python _multihost_prog.py PROC NPROC DEVS_PER_PROC PORT OUT
Process 0 writes counts + learned weights to OUT (.npz).
"""

import os
import sys


def main(proc: int, nproc: int, devs: int, port: int, out: str):
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
    from numbskull_jax.ops.gibbs import LearnParams
    from numbskull_jax.parallel.sharded import ShardedGibbsEngine

    # every process builds the same graph (the multihost contract)
    a, b, c = 0.5, -0.4, 0.3
    w, v, f, fm, dm, e = coin_model(40, a, b, c, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=7)
    cg = compile_graph(w, v, f, fm, domain_mask=dm)

    mesh = multihost.global_mesh(n_chains=2)
    eng = ShardedGibbsEngine(cg, mesh)
    st = eng.init_state()
    st = eng.learn(st, jax.random.PRNGKey(3), epochs=60, stepsize=0.1,
                   decay=0.98, burn=5,
                   lp=LearnParams(regularization=2, reg_param=1e-4))
    st = eng.inference(st, jax.random.PRNGKey(0), epochs=400, burn=20)

    # replicate the chain-sharded tallies so every process can read them
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = jax.jit(lambda x: x,
                  out_shardings=NamedSharding(mesh, P()))
    counts = np.asarray(rep(st.count))
    weights = np.asarray(rep(st.weight_value))
    if multihost.is_coordinator():
        np.savez(out, counts=counts, weights=weights,
                 nproc=nproc, n_devices=len(jax.devices()))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         int(sys.argv[4]), sys.argv[5])
