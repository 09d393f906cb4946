"""Checkpoint / resume: bit-exact continuation."""

import numpy as np

import jax

from numbskull_jax.checkpoint import load_checkpoint, save_checkpoint
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import ising_grid
from numbskull_jax.ops import GibbsEngine


def test_resume_bit_exact(tmp_path):
    args = ising_grid(4, 4, weight=0.3)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    eng = GibbsEngine(cg)

    # uninterrupted: 50 epochs in two calls with a deterministic key chain
    key = jax.random.PRNGKey(42)
    k1, k2 = jax.random.split(key)
    st = eng.init_state()
    st = eng.inference(st, k1, 25, burn=10)
    full = eng.inference(st, k2, 25, burn=0)

    # interrupted: checkpoint after the first call, reload, continue
    st2 = eng.init_state()
    st2 = eng.inference(st2, k1, 25, burn=10)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, st2, k2, meta={"epochs_done": 25})
    st3, k3, meta = load_checkpoint(path)
    assert meta == {"epochs_done": 25}
    resumed = eng.inference(st3, k3, 25, burn=0)

    assert (np.asarray(full.count) == np.asarray(resumed.count)).all()
    assert (np.asarray(full.var_value) ==
            np.asarray(resumed.var_value)).all()


def test_checkpoint_preserves_weights(tmp_path):
    args = ising_grid(3, 3, weight=0.7, fixed=False)
    w, v, f, fm, dm, e = args
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    eng = GibbsEngine(cg)
    st = eng.init_state()
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, st, jax.random.PRNGKey(0))
    st2, _, _ = load_checkpoint(path)
    assert np.asarray(st2.weight_value)[0] == np.float32(0.7)
