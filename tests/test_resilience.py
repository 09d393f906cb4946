"""Failure recovery, fault injection, stall detection, metrics.

The reference has none of these (SURVEY.md §5): failures abort the run
and there is no mid-run persistence. These tests prove the recovery path
is BIT-EXACT: a run that crashes and resumes produces identical tallies
to an uninterrupted one.
"""

import time

import numpy as np
import pytest

import jax

from numbskull_jax.compile import compile_graph
from numbskull_jax.models import coin_model
from numbskull_jax.observability import Metrics, metrics
from numbskull_jax.ops import GibbsEngine
from numbskull_jax.resilience import (
    FaultInjector, StallError, call_with_timeout, run_resilient,
)


def _engine():
    w, v, f, fm, dm, e = coin_model(
        3, 0.3, -0.2, 0.4, evidence=False,
        weight_init=(0.3, -0.2, 0.4), fixed=True)
    return GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm))


def test_resilient_run_bit_exact_after_faults(tmp_path):
    eng = _engine()
    key = jax.random.PRNGKey(7)

    clean = run_resilient(eng, eng.init_state(), key, epochs=200,
                          ckpt_path=str(tmp_path / "clean.npz"), chunk=50)

    faulty = run_resilient(eng, eng.init_state(), key, epochs=200,
                           ckpt_path=str(tmp_path / "faulty.npz"), chunk=50,
                           fault_hook=FaultInjector(fail_at=(1, 3)))

    np.testing.assert_array_equal(np.asarray(clean.count),
                                  np.asarray(faulty.count))
    np.testing.assert_array_equal(np.asarray(clean.var_value),
                                  np.asarray(faulty.var_value))


def test_resilient_resume_across_processes(tmp_path):
    """Elastic restart: a second invocation picks up where a dead one
    stopped and finishes identically."""
    eng = _engine()
    key = jax.random.PRNGKey(3)
    ckpt = str(tmp_path / "resume.npz")

    clean = run_resilient(eng, eng.init_state(), key, epochs=120,
                          ckpt_path=str(tmp_path / "ref.npz"), chunk=40)

    # first "process" dies after 2 chunks (injector exhausts retries)
    with pytest.raises(RuntimeError):
        run_resilient(eng, eng.init_state(), key, epochs=120,
                      ckpt_path=ckpt, chunk=40, max_retries=0,
                      fault_hook=FaultInjector(fail_at=(2,)))
    # relaunch resumes from the checkpoint
    resumed = run_resilient(eng, eng.init_state(), key, epochs=120,
                            ckpt_path=ckpt, chunk=40)
    np.testing.assert_array_equal(np.asarray(clean.count),
                                  np.asarray(resumed.count))


def test_call_with_timeout_detects_stall():
    with pytest.raises(StallError):
        call_with_timeout(time.sleep, 0.2, 5.0)
    assert call_with_timeout(lambda x: x + 1, 5.0, 41) == 42


def test_metrics_registry():
    m = Metrics()
    m.add("epochs", 10)
    m.add("epochs", 5)
    with m.time("sweep"):
        time.sleep(0.01)
    snap = m.snapshot()
    assert snap["counters"]["epochs"] == 15
    assert snap["timings"]["sweep"]["count"] == 1
    assert snap["timings"]["sweep"]["total_s"] > 0


def test_engine_feeds_default_metrics():
    metrics.reset()
    eng = _engine()
    st = eng.init_state()
    from numbskull_jax.numbskull import FactorGraph
    fg = FactorGraph(eng.cg, 0)
    fg.inference(0, 5)
    snap = metrics.snapshot()
    assert snap["counters"]["inference.epochs"] >= 5


def test_resilient_learning_bit_exact_after_faults(tmp_path):
    """run_resilient(task='learning'): weight learning in checkpointed
    chunks recovers bit-exactly from injected faults, continuing the
    stepsize decay schedule at the chunk's absolute epoch index
    (reference learning loop factorgraph.py:190-204 had no recovery)."""
    eng = _engine()
    key = jax.random.PRNGKey(11)

    clean = run_resilient(eng, eng.init_state(), key, epochs=80,
                          ckpt_path=str(tmp_path / "cl.npz"), chunk=20,
                          task="learning", stepsize=0.05, decay=0.97)
    faulty = run_resilient(eng, eng.init_state(), key, epochs=80,
                           ckpt_path=str(tmp_path / "fl.npz"), chunk=20,
                           task="learning", stepsize=0.05, decay=0.97,
                           fault_hook=FaultInjector(fail_at=(1, 2)))
    np.testing.assert_array_equal(np.asarray(clean.weight_value),
                                  np.asarray(faulty.weight_value))
    np.testing.assert_array_equal(np.asarray(clean.var_value_evid),
                                  np.asarray(faulty.var_value_evid))
