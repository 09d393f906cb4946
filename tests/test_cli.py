"""End-to-end CLI tests (reference analog: test.py integration smoke)."""

import os
import pytest

import numpy as np

from numbskull_jax.numbskull import NumbSkull, load, main

REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "coin18")


def test_cli_end_to_end(tmp_path):
    out = str(tmp_path)
    main([REF_DIR, "-l", "100", "-i", "50", "-b", "5", "-s", "0.2",
          "-d", "0.99", "-o", out, "-q"])
    probs = np.loadtxt(os.path.join(out, "inference_result.out.text"))
    assert probs.shape == (18, 3)
    assert (probs[:, 0] == np.arange(18)).all()
    assert (probs[:, 1] == 1).all()
    assert ((probs[:, 2] >= 0) & (probs[:, 2] <= 1)).all()
    wts = np.loadtxt(os.path.join(out, "inference_result.out.weights.text"))
    assert wts.shape == (2,)
    assert wts[0] == 0
    # 8/9 evidence vars are 1 -> learned ISTRUE weight clearly positive
    assert wts[1] > 0.2


def test_cli_grad_agg_sum_matches_reference_movement(tmp_path):
    """With --grad_agg sum and reference defaults (s=0.01, d=0.95), the
    learned coin weight lands where the reference's decay-limited
    sequential SGD does (~0.7-0.8; reference learning.py:111-125)."""
    out = str(tmp_path)
    main([REF_DIR, "-l", "100", "-i", "10", "-b", "10",
          "--grad_agg", "sum", "-o", out, "-q"])
    wts = np.loadtxt(os.path.join(out, "inference_result.out.weights.text"))
    assert 0.55 < wts[1] < 1.0


def test_cli_checkpoint_resume(tmp_path):
    """--checkpoint: a chunked run is BIT-EXACT vs an uninterrupted one
    (per-epoch keys are folded at absolute epoch indices), and an
    interrupted run resumes to the same exact output."""
    out1, out2, out3 = (str(tmp_path / d) for d in "abc")
    ck = str(tmp_path / "ck.npz")
    main([REF_DIR, "-i", "120", "-o", out1, "-q", "--seed", "5"])
    main([REF_DIR, "-i", "120", "-o", out2, "-q", "--seed", "5",
          "--checkpoint", ck, "--checkpoint_every", "40"])
    p1 = np.loadtxt(os.path.join(out1, "inference_result.out.text"))
    p2 = np.loadtxt(os.path.join(out2, "inference_result.out.text"))
    assert p1.shape == p2.shape
    assert (p1 == p2).all()
    # simulated interrupt: run 80 epochs (2 chunks), then resume to 120
    ck2 = str(tmp_path / "ck2.npz")
    main([REF_DIR, "-i", "80", "-o", str(tmp_path / "x"), "-q",
          "--seed", "5", "--checkpoint", ck2, "--checkpoint_every", "40"])
    main([REF_DIR, "-i", "120", "-o", out3, "-q", "--seed", "5",
          "--checkpoint", ck2, "--checkpoint_every", "40"])
    p3 = np.loadtxt(os.path.join(out3, "inference_result.out.text"))
    assert (p1 == p3).all()


def test_cli_learning_checkpoint_resume(tmp_path):
    """--checkpoint now also covers LEARNING (weights + both chains +
    stepsize epoch index, persisted to <ck>.learn): an interrupted
    learning run resumed to completion produces the same weights as an
    uninterrupted chunked run (the reference's long learning runs had
    no persistence at all — factorgraph.py:190-204)."""
    out1, out3 = str(tmp_path / "a"), str(tmp_path / "c")
    ck = str(tmp_path / "ck.npz")
    main([REF_DIR, "-l", "120", "-i", "5", "-o", out1, "-q",
          "--seed", "5", "--checkpoint", ck, "--checkpoint_every", "40"])
    w1 = np.loadtxt(os.path.join(out1, "inference_result.out.weights.text"))
    assert os.path.exists(ck + ".learn")
    # simulated interrupt after 80 learning epochs, then resume to 120
    ck2 = str(tmp_path / "ck2.npz")
    main([REF_DIR, "-l", "80", "-i", "5", "-o", str(tmp_path / "x"),
          "-q", "--seed", "5", "--checkpoint", ck2,
          "--checkpoint_every", "40"])
    main([REF_DIR, "-l", "120", "-i", "5", "-o", out3, "-q",
          "--seed", "5", "--checkpoint", ck2, "--checkpoint_every", "40"])
    w3 = np.loadtxt(os.path.join(out3, "inference_result.out.weights.text"))
    assert (w1 == w3).all()
    # relaunching an ALREADY-COMPLETE run (elastic restart) must not
    # crash — incl. with diagnostics on (no -q), where the learn loop
    # body never executes (regression: _last_learn_s was unset)
    main([REF_DIR, "-l", "120", "-i", "5", "-o", out3,
          "--seed", "5", "--checkpoint", ck2, "--checkpoint_every", "40"])


def test_cli_checkpoint_every_zero_terminates(tmp_path):
    """--checkpoint_every 0 must clamp to 1, not spin forever."""
    ck = str(tmp_path / "ck.npz")
    main([REF_DIR, "-i", "3", "-o", str(tmp_path), "-q",
          "--checkpoint", ck, "--checkpoint_every", "0"])
    assert os.path.exists(ck)


def test_dump_probabilities_multivalue(tmp_path):
    """Dense multi-valued variables dump one line per value (the
    reference's dump reads past its single vmap slot here — a latent
    bug its tests never hit; we write identity values)."""
    from numbskull_jax.models import lf_model

    ns = NumbSkull(n_inference_epoch=50, quiet=True,
                   output_dir=str(tmp_path))
    ns.loadFactorGraph(*lf_model(0.3, [0.9], copies=2, seed=0))
    ns.inference(out=True)
    lines = open(os.path.join(
        str(tmp_path), "inference_result.out.text")).read().splitlines()
    # 2 copies x (1 boolean y + 1 card-3 LF) -> 2*1 + 2*3 = 8 lines
    assert len(lines) == 8
    probs = np.array([[float(x) for x in ln.split()] for ln in lines])
    for v in (1, 3):                      # card-3 vars sum to ~1
        s = probs[probs[:, 0] == v, 2].sum()
        assert abs(s - 1.0) < 0.05


def test_load_api():
    ns = load([REF_DIR, "-q"])
    assert len(ns.factorGraphs) == 1
    assert ns.factorGraphs[0].cg.n_vars == 18


def test_api_coverage_diagnostics_and_raw_load(capsys):
    """Diagnostics histogram/weight prints, compressed getMarginals, and
    loadFactorGraphRaw (prebuilt CompiledGraph) all function."""
    from numbskull_jax.compile import compile_graph
    from numbskull_jax.models import coin_model, lf_model

    ns = NumbSkull(n_inference_epoch=20, n_learning_epoch=10, burn_in=2,
                   quiet=False, verbose=True)
    ns.loadFactorGraph(*coin_model(3, evidence=True))
    ns.learning(out=False)
    ns.inference(out=False)
    out = capsys.readouterr().out
    assert "Prob. 0.9..1.0" in out          # histogram printed
    assert "weightId" in out                # learning diagnostics
    fg = ns.factorGraphs[0]
    assert fg.getMarginals(20).shape == (6,)

    w, v, f, fm, dm, e = lf_model(0.3, [0.9], copies=2, seed=0)
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    ns2 = NumbSkull(n_inference_epoch=10, quiet=True)
    ns2.loadFactorGraphRaw(cg)
    ns2.inference(out=False)
    assert len(ns2.factorGraphs) == 1


def test_remaining_api_surface():
    """Every public function is exercised somewhere: burnIn,
    getFactorGraph, device_memory_stats, is_coordinator."""
    from numbskull_jax.models import coin_model
    from numbskull_jax.observability import device_memory_stats
    from numbskull_jax.parallel.multihost import is_coordinator

    ns = NumbSkull(quiet=True)
    ns.loadFactorGraph(*coin_model(2, evidence=True))
    fg = ns.getFactorGraph(0)
    fg.burnIn(3, sample_evidence=True)
    assert fg is ns.factorGraphs[0]
    stats = device_memory_stats()
    assert isinstance(stats, list) and "device" in stats[0]
    assert is_coordinator() is True        # single-process


@pytest.mark.slow
def test_programmatic_smoke():
    """Analog of reference loadfg.py: every factor function learns+infers
    without crashing."""
    from numbskull_jax import types as T

    for name, code in T.FACTORS.items():
        if code == T.FUNC_NOOP:
            continue
        nvars = 3 if name in ("DP_GEN_DEP_FIXING",
                              "DP_GEN_DEP_REINFORCING") else 2
        weight = T.new_weights(1)
        weight["isFixed"] = True
        weight["initialValue"] = 1
        variable = T.new_variables(nvars)
        variable["cardinality"] = 2
        factor = T.new_factors(1)
        factor["factorFunction"] = code
        factor["weightId"] = 0
        factor["featureValue"] = 1
        factor["arity"] = nvars
        fmap = T.new_fmap(nvars)
        fmap["vid"] = np.arange(nvars)
        ns = NumbSkull(n_inference_epoch=20, n_learning_epoch=20,
                       quiet=True)
        ns.loadFactorGraph(weight, variable, factor, fmap,
                           np.zeros(nvars, bool), nvars)
        ns.learning(out=False)
        ns.inference(out=False)
        counts = ns.factorGraphs[0].state.count
        assert int(np.asarray(counts).sum()) == 20 * nvars, name


def test_cli_distributed_parts_matches_single(tmp_path):
    """--parts N: the one-command distributed run (reference
    numbskull_master.main parity, salt/src/numbskull_master.py:547-584)
    on a keyed sqlite graph produces weights and marginals matching the
    single-part run within sampling tolerance, and writes the same
    output files."""
    import sqlite3

    from numbskull_jax import dbsource
    from numbskull_jax.models import coin_model

    w, v, f, fm, dm, e = coin_model(60, 0.8, -0.5, 0.4, evidence=True,
                                    weight_init=(0.0, 0.0, 0.0),
                                    fixed=False, seed=3)
    var_keys = ["B" if i % 2 == 0 else "D1" for i in range(len(v))]
    first_vid = fm["vid"][f["ftv_offset"].astype(np.int64)]
    factor_keys = ["Du1" if f["arity"][i] == 2 else
                   ("B" if first_vid[i] % 2 == 0 else "D1")
                   for i in range(len(f))]
    db = str(tmp_path / "g.db")
    conn = sqlite3.connect(db)
    dbsource.write_graph_to_db(conn.cursor(), "coin", w, v, f, fm,
                               var_keys=var_keys,
                               factor_keys=factor_keys)
    conn.commit()
    conn.close()

    out1, out2 = str(tmp_path / "single"), str(tmp_path / "dist")
    main(["-u", "sqlite:///" + db, "-l", "60", "-i", "200", "-b", "10",
          "-o", out1, "-q", "--seed", "2"])
    main(["-u", "sqlite:///" + db, "-l", "60", "-i", "200", "-b", "10",
          "-o", out2, "-q", "--seed", "2", "--parts", "2"])
    p1 = np.loadtxt(os.path.join(out1, "inference_result.out.text"))
    p2 = np.loadtxt(os.path.join(out2, "inference_result.out.text"))
    w1 = np.loadtxt(os.path.join(out1,
                                 "inference_result.out.weights.text"))
    w2 = np.loadtxt(os.path.join(out2,
                                 "inference_result.out.weights.text"))
    assert p1.shape == p2.shape
    # same learned weight directions, marginals within MC tolerance
    assert np.sign(w1[np.abs(w1[:, 1]) > 0.1, 1]).tolist() == \
        np.sign(w2[np.abs(w1[:, 1]) > 0.1, 1]).tolist()
    # non-evidence variables only: the single-part engine does not
    # tally evidence vars (their single-part prob is 0 by convention)
    free = p1[:, 2] > 0
    assert free.sum() >= len(p1) // 2
    assert np.abs(p1[free, 2] - p2[free, 2]).mean() < 0.08
