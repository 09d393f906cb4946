"""End-to-end timing of gather strategies for the padded inference path.

The padded color step reads the argument values of every item slot from
the permuted state with one gather (``ops/gibbs.py:_gather_padded``). This
script times ``GibbsEngine.inference`` end to end, in epochs per second,
with each candidate patched in:

  plain    xp[idx]                         the engine's gather
  onehot   one-hot bf16 matrix product over 128-wide rows of the state,
           then a masked lane select (exact for values < 256)
  row8     gather of 8-wide rows, then a masked select

on three graphs: the 256x256 and 1024x1024 Ising grids compiled as
general graphs (no color hint), and grouped voting, degree 10, 200k
variables. The one-hot candidate is skipped where its operand for one
color step would exceed ``ONEHOT_MAX_BYTES``. Every candidate must give
tallies equal to the plain gather's, bit for bit (the gather is exact).

Run on the GPU: PYTHONPATH=. python experiments/gather_strategies.py [out.jsonl]
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from numbskull_jax.benchutil import card_name_and_power_limit
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import ising_grid, voting_grouped
from numbskull_jax.ops import GibbsEngine
from numbskull_jax.ops import gibbs

ONEHOT_MAX_BYTES = 4 << 30


def plain(xp, idx):
    return xp[idx]


def onehot(xp, idx):
    flat = idx.reshape(-1)
    vr = xp.shape[0] // 128
    roh = ((flat[:, None] >> 7) ==
           jnp.arange(vr, dtype=jnp.int32)[None]).astype(jnp.bfloat16)
    rows = jax.lax.dot_general(
        roh, xp.reshape(vr, 128).astype(jnp.bfloat16),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)              # (N, 128)
    loh = (flat[:, None] & 127) == jnp.arange(128, dtype=jnp.int32)[None]
    out = jnp.sum(jnp.where(loh, rows, 0.0), axis=1).astype(jnp.int32)
    return out.reshape(idx.shape)


def row8(xp, idx):
    flat = idx.reshape(-1)
    rows = xp.reshape(xp.shape[0] // 8, 8)[flat >> 3]     # (N, 8)
    loh = (flat[:, None] & 7) == jnp.arange(8, dtype=jnp.int32)[None]
    return jnp.sum(jnp.where(loh, rows, 0), axis=1).reshape(idx.shape)


STRATEGIES = {"plain": plain, "onehot": onehot, "row8": row8}


def graphs():
    for n in (256, 1024):
        w, v, f, fm, dm, e = ising_grid(n, n, weight=0.3)
        yield "ising_general_%d" % n, compile_graph(w, v, f, fm,
                                                    domain_mask=dm)
    w, v, f, fm, dm, e = voting_grouped(200_000, 10, weight=0.3)
    yield "voting_deg10_200k", compile_graph(w, v, f, fm, domain_mask=dm)


def time_strategy(cg, gather, epochs=None, reps=3):
    """(epochs/s, epochs, counts) for one strategy: compile and warm up,
    then the best of ``reps`` timed runs ending in block_until_ready."""
    gibbs._gather_padded = gather
    eng = GibbsEngine(cg)
    assert eng.padded is not None, "padded path inactive"
    st = eng.init_state()
    key = jax.random.PRNGKey(1)
    t0 = time.perf_counter()
    jax.block_until_ready(eng.inference(st, key, 4).count)
    compile_s = time.perf_counter() - t0
    if epochs is None:                   # aim at ~1 s per timed run
        t0 = time.perf_counter()
        jax.block_until_ready(eng.inference(st, key, 20).count)
        per = (time.perf_counter() - t0) / 20
        epochs = int(min(max(20, 1.0 / max(per, 1e-6)), 20000))
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(eng.inference(st, key, epochs).count)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return epochs / best, epochs, np.asarray(out), compile_s


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else ""
    card = card_name_and_power_limit()
    dev = jax.devices()[0]
    lines = []
    for gname, cg in graphs():
        ref = None
        epochs = None
        # two rounds in mirrored order: plain onehot row8 row8 onehot plain
        order = list(STRATEGIES) + list(reversed(STRATEGIES))
        m = GibbsEngine(cg).padded_meta
        op_bytes = m.R * m.D * m.Ag * (m.Vp // 128) * 2
        for name in order:
            rec = {"graph": gname, "strategy": name, "n_vars": cg.n_vars,
                   "colors": m.C, "rows": m.R, "slots": m.D,
                   "gathered_args": m.Ag, "Vp": m.Vp,
                   "device_kind": dev.device_kind,
                   "card": card}
            if name == "onehot" and op_bytes > ONEHOT_MAX_BYTES:
                rec["skipped"] = "one-hot operand %.1f GB per color step" % (
                    op_bytes / 1e9)
            else:
                eps, epochs, cnt, comp = time_strategy(
                    cg, STRATEGIES[name], epochs)
                if ref is None:
                    ref = cnt
                rec.update(epochs_per_s=eps,
                           var_updates_per_s=eps * cg.n_vars,
                           timed_epochs=epochs, compile_s=comp,
                           equal_to_first=bool(np.array_equal(cnt, ref)))
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    gibbs._gather_padded = plain
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as fh:
            for rec in lines:
                fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
