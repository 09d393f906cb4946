"""Multi-PROCESS distributed execution proof.

The reference validated multi-machine runs only on live salt clusters
(SURVEY.md §4 "no single-process multi-node harness"); here the
cluster is emulated faithfully on one box: the test spawns real OS
processes, each owning a slice of virtual CPU devices, joined by
jax.distributed (Gloo collectives across process boundaries) into one
global mesh. The 2-process x 2-device run must produce BIT-IDENTICAL
tallies and learned weights to the 1-process x 4-device run — the SPMD
program is the same; only the process topology changes (the property a
multi-host job relies on).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

PROG = os.path.join(os.path.dirname(__file__), "_multihost_prog.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(nproc: int, devs_per_proc: int, out: str):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    # the spawned prog imports numbskull_jax by path (the package need
    # not be pip-installed); sys.path[0] for a script is tests/, so the
    # repo root must ride PYTHONPATH
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, PROG, str(p), str(nproc), str(devs_per_proc),
         str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(nproc)]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-2000:]
    return np.load(out)


@pytest.mark.slow
def test_two_process_run_matches_single_process(tmp_path):
    single = _run(1, 4, str(tmp_path / "single.npz"))
    multi = _run(2, 2, str(tmp_path / "multi.npz"))
    assert int(single["n_devices"]) == 4
    assert int(multi["n_devices"]) == 4
    assert int(multi["nproc"]) == 2
    # same global mesh shape, same keys -> bit-identical results across
    # process topologies
    assert (single["counts"] == multi["counts"]).all()
    assert np.array_equal(single["weights"], multi["weights"])
    # and the learning actually moved toward the generating weights
    w = multi["weights"]
    assert w[0] > 0.1 and w[1] < -0.05 and w[2] > 0.05
