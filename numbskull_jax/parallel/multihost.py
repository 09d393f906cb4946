"""Multi-host execution.

The reference's multi-machine story is a SaltStack master/minion cluster
with hand-rolled TCP channels (reference: salt/src/, SURVEY.md §2.6; the
older pyzmq protocol in numbskull/distributed.py is its broken
predecessor). The JAX equivalent is ~30 lines: initialize
jax.distributed, build one global mesh spanning every host's devices,
and run the exact same ShardedGibbsEngine — collectives ride NVLink
within a host and the network across hosts, with no user-visible
difference.

Typical multi-host GPU usage (same program on every host):

    from numbskull_jax.parallel import multihost
    multihost.initialize("10.0.0.1:1234", num_processes=2,
                         process_id=int(os.environ["RANK"]))
    mesh = multihost.global_mesh(n_chains=4)    # chains x graph over all
    eng = ShardedGibbsEngine(cg, mesh)          # devices in the job
    ...

A GPU job outside a cluster manager that JAX detects (SLURM, Open MPI)
must pass all three arguments: the coordinator's ``host:port`` (the
same on every process, reachable from all of them), the number of
processes, and this process's id in ``[0, num_processes)``.

Every host must build the same CompiledGraph (same files, same seed);
per-host *loading* can be reduced with parallel.partition plans when
graphs are too large to parse everywhere.
"""

from __future__ import annotations

import jax

from numbskull_jax.parallel.mesh import make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed. All-None leaves discovery to JAX, which
    works only under a cluster manager it detects (SLURM, Open MPI); a
    plain GPU job passes all three arguments (see the module docstring).

    Must run before anything touches the XLA backend (so this function
    checks the distributed client directly rather than calling
    jax.process_count, which would initialise it)."""
    from jax._src import distributed as _dist
    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes,
                      process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(n_chains: int = 1,
                n_graph: int | None = None) -> jax.sharding.Mesh:
    """(chains, graph) mesh over every device in the job (all hosts)."""
    return make_mesh(n_chains=n_chains, n_graph=n_graph,
                     devices=jax.devices())


def is_coordinator() -> bool:
    """True on the process that should write outputs (the 'master')."""
    return jax.process_index() == 0
