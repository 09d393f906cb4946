"""Failure detection, fault injection, and checkpoint-based recovery.

The reference's failure story is a liveness poll before start and a FAIL
status that aborts the whole run (reference:
salt/src/numbskull_master.py:506-544, salt/src/numbskull_minion.py:70-91;
SURVEY.md §5: "No elasticity, no checkpoint-based recovery, no fault
injection"). Here:

- ``run_resilient``: drives a sampler in checkpointed chunks; any failure
  restores the last checkpoint and retries, and because the sweep is a
  pure function of (state, key, epoch-index) with counter-based RNG, the
  recovered run is BIT-EXACT with an uninterrupted one (on the CPU, and
  measured on an H100 GPU too, resuming in the same process or a new
  one; see checkpoint.py).
- ``FaultInjector``: deterministic fault injection for testing the
  recovery path (fails at chosen chunk indices).
- ``call_with_timeout``: stall detection for device calls — the caller
  gets a ``StallError`` after ``timeout_s`` even if the underlying XLA
  execution is hung (the computation itself cannot be cancelled; the
  caller decides whether to re-init devices or abort).
"""

from __future__ import annotations

import concurrent.futures as _futures
import os

import jax

from numbskull_jax.checkpoint import load_checkpoint, save_checkpoint
from numbskull_jax.observability import metrics


class StallError(RuntimeError):
    pass


def call_with_timeout(fn, timeout_s: float, *args, **kwargs):
    """Run fn in a worker thread; raise StallError if it exceeds
    timeout_s (the hung call keeps running — XLA executions are not
    cancellable — but the caller regains control)."""
    with _futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(fn, *args, **kwargs)
        try:
            return fut.result(timeout=timeout_s)
        except _futures.TimeoutError:
            raise StallError(
                "call exceeded %.1fs (device stall?)" % timeout_s) from None


class FaultInjector:
    """Raises RuntimeError before executing the chunks in ``fail_at``
    (each index fires once) — deterministic failure for recovery tests."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def __call__(self, chunk_index: int) -> None:
        if chunk_index in self.fail_at and chunk_index not in self.fired:
            self.fired.add(chunk_index)
            raise RuntimeError("injected fault at chunk %d" % chunk_index)


def run_resilient(engine, state, key, epochs: int, ckpt_path: str,
                  chunk: int = 100, burn: int = 0,
                  max_retries: int = 3, fault_hook=None,
                  step_timeout_s: float | None = None,
                  task: str = "inference", stepsize: float = 0.01,
                  decay: float = 0.95, **engine_kwargs):
    """Run ``engine.inference`` (or ``engine.learn`` with
    ``task="learning"``) for ``epochs`` in checkpointed chunks.

    Resumes from ``ckpt_path`` if it exists (elastic restart: the process
    can die and be relaunched with the same arguments). ``fault_hook``
    (chunk_index -> None) may raise to simulate failures. Learning
    chunks continue the stepsize schedule exactly: chunk c starts at
    ``stepsize * decay**epochs_done``, matching the engine's per-epoch
    exponential decay (reference learning loop factorgraph.py:190-204).
    Returns the final state.
    """
    done = 0
    if os.path.exists(ckpt_path):
        state, key, meta = load_checkpoint(ckpt_path)
        done = int(meta.get("epochs_done", 0))
        burn = 0 if done > 0 else burn
        metrics.add("resilience.resumes")

    chunk_index = done // max(chunk, 1)
    while done < epochs:
        n = min(chunk, epochs - done)
        retries = 0
        while True:
            try:
                if fault_hook is not None:
                    fault_hook(chunk_index)
                ck = jax.random.fold_in(key, chunk_index)

                def _step():
                    if task == "learning":
                        out = engine.learn(
                            state, ck, epochs=n,
                            stepsize=stepsize * decay ** done,
                            decay=decay,
                            burn=burn if done == 0 else 0,
                            **engine_kwargs)
                        jax.block_until_ready(out.weight_value)
                        return out
                    out = engine.inference(state, ck, epochs=n,
                                           burn=burn if done == 0 else 0,
                                           **engine_kwargs)
                    jax.block_until_ready(out.count)
                    return out

                if step_timeout_s is not None:
                    new_state = call_with_timeout(_step, step_timeout_s)
                else:
                    new_state = _step()
                break
            except StallError:
                raise
            except Exception:
                retries += 1
                metrics.add("resilience.retries")
                if retries > max_retries:
                    raise
                if os.path.exists(ckpt_path):
                    state, key, meta = load_checkpoint(ckpt_path)
                    done = int(meta.get("epochs_done", 0))
        state = new_state
        done += n
        chunk_index += 1
        save_checkpoint(ckpt_path, state, key,
                        meta={"epochs_done": done})
        metrics.add("resilience.chunks")
        metrics.add("resilience.epochs", n)
    return state
