"""Sampler checkpoint / resume.

The reference has NO mid-run persistence — only terminal text dumps
(reference: numbskull/factorgraph.py:210-229; SURVEY.md §5 "Checkpoint /
resume: none"). Here the full sampler state (both chains, weights,
tallies, RNG key, epoch counters) round-trips through a single .npz, so
long inference/learning runs survive restarts and can be resumed
bit-exactly (counter-based jax.random keys make the continuation
deterministic). This holds on the CPU and was measured on an H100 GPU
with JAX 0.9.0 (experiments/determinism.py): learning's float
scatter-adds came out bit-identical from run to run there, and so did
CLI runs resumed in the same process and in a new one.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from numbskull_jax.ops.gibbs import SamplerState

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: SamplerState, key,
                    meta: dict | None = None) -> None:
    """Persist sampler state + RNG key (+ JSON-serializable metadata)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        format_version=_FORMAT_VERSION,
        var_value=np.asarray(state.var_value),
        var_value_evid=np.asarray(state.var_value_evid),
        weight_value=np.asarray(state.weight_value),
        count=np.asarray(state.count),
        key=np.asarray(jax.random.key_data(key)),
        meta=json.dumps(meta or {}),
    )
    # numpy appends .npz to names without it
    written = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(written, path)


def load_checkpoint(path: str):
    """Returns (SamplerState, key, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        assert version == _FORMAT_VERSION, f"unknown version {version}"
        state = SamplerState(
            var_value=jnp.asarray(z["var_value"]),
            var_value_evid=jnp.asarray(z["var_value_evid"]),
            weight_value=jnp.asarray(z["weight_value"]),
            count=jnp.asarray(z["count"]),
        )
        key = jax.random.wrap_key_data(jnp.asarray(z["key"]))
        meta = json.loads(str(z["meta"]))
    return state, key, meta
