"""chip_smoke.py: refuses to run without a GPU; the shape of its last
line; its golden phase fails on planted faults; its phases on a GPU
(``chip`` marker)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from numbskull_jax import types as T  # noqa: E402
from numbskull_jax.compile import compile_graph  # noqa: E402
from numbskull_jax.models import voting_grouped  # noqa: E402
from numbskull_jax.ops import GibbsEngine  # noqa: E402


def test_refuses_without_gpu():
    """On a CPU backend the script exits non-zero and prints no result
    line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_result_line_shape():
    """Exactly {"ok": true, "device": {"platform", "kind", "count"}},
    with the device as JAX reports it."""
    devs = jax.devices()[:4]
    got = json.loads(chip_smoke.result_line(devs))
    assert got == {"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}


def _plant(eng, fault):
    """Corrupt the engine's padded plan: AND factors evaluated as OR, or
    every argument read from the next state slot."""
    pp, meta = eng.padded, eng.padded_meta
    if fault == "factor_type":
        eng.padded = dict(pp, it_ftype=jnp.where(
            pp["it_ftype"] == T.FUNC_AND, T.FUNC_OR, pp["it_ftype"]))
    elif fault == "shifted_gather":
        eng.padded = dict(pp, g_idx=jnp.minimum(pp["g_idx"] + 1,
                                                 meta.Vp - 1))


@pytest.mark.parametrize("fault", ["none", "factor_type", "shifted_gather"])
def test_golden_phase_catches_planted_fault(fault):
    """The golden phase passes on the engine as built and fails when its
    factor types or its gather indices are corrupted."""
    w, v, f, fm, dm, e = voting_grouped(20_000, 10, weight=0.0, fixed=False,
                                        evidence_frac=0.3, seed=0)
    eng = GibbsEngine(compile_graph(w, v, f, fm, domain_mask=dm))
    _plant(eng, fault)
    if fault == "none":
        rep = chip_smoke.phase_golden((w, v, f, fm), eng, 0, n_samples=200)
        assert rep["max_abs_err"] <= chip_smoke.GOLDEN_ABS
        assert rep["live"] >= chip_smoke.GOLDEN_MIN_LIVE * rep["potentials"]
    else:
        with pytest.raises(AssertionError, match="golden"):
            chip_smoke.phase_golden((w, v, f, fm), eng, 0, n_samples=200)


def test_four_part_bsp_phase_cuts_factors(tmp_path):
    """The --four BSP phase on a small grid over four devices: the sync
    ships boundary values and both modes match the exact marginal (within
    a wider limit: a small grid's mean fluctuates more)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    chip_smoke.run_four_bsp(0, str(tmp_path), side=32, epochs=300, burn=30,
                            tol=0.03)


def test_boundary_mask():
    """A variable is on the boundary when a factor joins it to a variable
    of another part."""
    f = T.new_factors(2)
    f["arity"] = 2
    fm = T.new_fmap(4)
    fm["vid"] = [0, 1, 1, 2]
    part = np.array([0, 0, 1])
    assert chip_smoke.boundary_mask(fm, f, part).tolist() == [False, True,
                                                              True]


@pytest.mark.chip
def test_phases_on_gpu(tmp_path):
    """Every one-card phase at a reduced size, on the card."""
    cli = chip_smoke.phase_cli_voting(str(tmp_path), 0, n_vars=50_000)
    assert cli["report"]["padded_path"]
    rep = chip_smoke.phase_golden(cli["graph"],
                                  cli["ns"].factorGraphs[0].engine, 0,
                                  n_samples=200)
    assert rep["max_abs_err"] <= 1e-4 and rep["live"] >= 0.1 * rep[
        "potentials"]
    chip_smoke.phase_coin_learn(0, copies=20_000)
    chip_smoke.phase_coin_infer(0, copies=20_000)
