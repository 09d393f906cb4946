"""Disk plan cache: hit/miss behavior, key sensitivity, result parity."""

import time

import numpy as np

from numbskull_jax import plancache
from numbskull_jax.compile import compile_graph
from numbskull_jax.models import ising_grid, voting_grouped


def _cg_equal(a, b):
    assert a.n_vars == b.n_vars and a.n_colors == b.n_colors
    np.testing.assert_array_equal(a.color_of, b.color_of)
    np.testing.assert_array_equal(a.var_init, b.var_init)
    for pa, pb in zip(a.plans, b.plans):
        np.testing.assert_array_equal(pa.it_row, pb.it_row)
        np.testing.assert_array_equal(pa.it_args_vid, pb.it_args_vid)
        np.testing.assert_array_equal(pa.cv_vid, pb.cv_vid)


def test_cache_round_trip_bit_equal(tmp_path):
    w, v, f, fm, dm, e = ising_grid(12, 12, weight=0.3)
    d = str(tmp_path)
    cg1 = compile_graph(w, v, f, fm, domain_mask=dm, cache=d)
    cg2 = compile_graph(w, v, f, fm, domain_mask=dm, cache=d)  # hit
    _cg_equal(cg1, cg2)
    # and the entry actually exists on disk
    assert any(p.name.endswith(".plan.pkl") for p in tmp_path.iterdir())


def test_cache_key_sensitive_to_inputs(tmp_path):
    w, v, f, fm, dm, e = ising_grid(8, 8, weight=0.3)
    d = str(tmp_path)
    compile_graph(w, v, f, fm, domain_mask=dm, cache=d)
    n1 = len(list(tmp_path.iterdir()))
    w2 = w.copy()
    w2["initialValue"] = 0.7          # different graph bytes -> new key
    compile_graph(w2, v, f, fm, domain_mask=dm, cache=d)
    n2 = len(list(tmp_path.iterdir()))
    assert n2 == n1 + 1
    # different compile knobs -> new key too
    compile_graph(w, v, f, fm, domain_mask=dm, cache=d, row_pad=16)
    assert len(list(tmp_path.iterdir())) == n2 + 1


def test_cache_second_compile_faster_large(tmp_path):
    """A second compile of a nontrivial graph must be near-instant."""
    w, v, f, fm, dm, e = voting_grouped(60_000, 10, weight=0.3, seed=1)
    d = str(tmp_path)
    t0 = time.perf_counter()
    compile_graph(w, v, f, fm, domain_mask=dm, cache=d)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    compile_graph(w, v, f, fm, domain_mask=dm, cache=d)
    warm = time.perf_counter() - t0
    assert warm < max(0.5 * cold, 0.25), (cold, warm)


def test_corrupt_entry_is_a_miss(tmp_path):
    w, v, f, fm, dm, e = ising_grid(6, 6, weight=0.3)
    d = str(tmp_path)
    compile_graph(w, v, f, fm, domain_mask=dm, cache=d)
    for p in tmp_path.iterdir():
        p.write_bytes(b"garbage")
    cg = compile_graph(w, v, f, fm, domain_mask=dm, cache=d)
    assert cg.n_vars == 36            # recompiled fine


def test_graph_key_distinguishes_none_and_scalars():
    a = plancache.graph_key(None, 1)
    b = plancache.graph_key(0, 1)
    c = plancache.graph_key(None, "1")
    assert len({a, b, c}) == 3
