"""Partitioner: components, balance, cut quality, ownership semantics."""

import numpy as np

from numbskull_jax.compile import compile_graph, conflict_edges
from numbskull_jax.models import ising_grid
from numbskull_jax.parallel.partition import (
    balanced_partition, choose_partition, connected_components, edge_cut,
    make_part_plans, partition_cost,
)


def test_choose_partition_prefers_zero_cut_components():
    """Disconnected graphs (e.g. the coin model's independent pairs)
    should pick the component packing (zero cut), like the reference's
    cc-partition scheme (numbskull_master.py:301-325)."""
    from numbskull_jax.models import coin_model
    w, v, f, fm, dm, e = coin_model(50, evidence=True)
    edges = conflict_edges(v, f, fm)
    part, report = choose_partition(len(v), edges, 4)
    assert report["chosen"] == "cc"
    assert edge_cut(edges, part) == 0
    sizes = np.bincount(part, minlength=4)
    assert sizes.max() <= 2 * sizes.min() + 2


def test_choose_partition_connected_graph():
    w, v, f, fm, dm, e = ising_grid(16, 16)
    edges = conflict_edges(v, f, fm)
    part, report = choose_partition(256, edges, 4)
    assert int(part.max()) + 1 == 4
    best = min(x for k, x in report.items() if k != "chosen")
    assert partition_cost(256, edges, part, 4) == best


def test_connected_components():
    edges = np.array([[0, 1], [1, 2], [4, 5]])
    cc = connected_components(7, edges)
    assert cc[0] == cc[1] == cc[2]
    assert cc[4] == cc[5]
    assert len({cc[0], cc[3], cc[4], cc[6]}) == 4


def test_balanced_partition_grid():
    w, v, f, fm, dm, e = ising_grid(16, 16)
    edges = conflict_edges(v, f, fm)
    part = balanced_partition(256, edges, 4, seed=1)
    sizes = np.bincount(part, minlength=4)
    assert sizes.max() - sizes.min() <= 2
    # BFS growing should beat a random partition's cut substantially
    rng = np.random.default_rng(0)
    rand_cut = edge_cut(edges, rng.integers(0, 4, 256))
    assert edge_cut(edges, part) < 0.7 * rand_cut


def test_part_plans_ownership():
    w, v, f, fm, dm, e = ising_grid(8, 8)
    edges = conflict_edges(v, f, fm)
    part = balanced_partition(64, edges, 2, seed=0)
    plans = make_part_plans(v, f, fm, part, 2)
    # every variable owned exactly once
    owned = np.stack([p.owned_mask for p in plans])
    assert (owned.sum(axis=0) == 1).all()
    # every factor sampled by exactly one part
    skip_sets = [set(p.factors_to_skip.tolist()) for p in plans]
    for fid in range(len(f)):
        assert sum(fid not in s for s in skip_sets) == 1
    # part-local graphs compile (factors_to_skip path)
    for p in plans:
        cg = compile_graph(w, p.variables, f, fm,
                           factors_to_skip=p.factors_to_skip)
        assert cg.n_vars == 64


def _planted_communities(n_comm=8, size=64, p_in=0.15, p_cross=0.004,
                         seed=0):
    """Connected community graph with SHUFFLED vertex ids: intra-
    community edges dense, sparse random cross links. RCM-order
    chunking cannot recover the communities from shuffled ids; a
    cut-minimizing partitioner can."""
    rng = np.random.default_rng(seed)
    V = n_comm * size
    comm = np.repeat(np.arange(n_comm), size)
    perm = rng.permutation(V)
    vid = np.empty(V, np.int64)
    vid[perm] = np.arange(V)          # community c members: vid[perm...]
    members = [np.flatnonzero(comm[np.argsort(perm)] == c)
               for c in range(n_comm)]
    edges = []
    for c in range(n_comm):
        m = perm[comm == c]
        a, b = np.meshgrid(m, m, indexing="ij")
        mask = (a < b) & (rng.random((size, size)) < p_in)
        edges.append(np.stack([a[mask], b[mask]], axis=1))
        # ring of communities keeps the graph connected
        m2 = perm[comm == (c + 1) % n_comm]
        edges.append(np.array([[m[0], m2[0]]]))
    a = rng.integers(0, V, size=int(p_cross * V * V))
    b = rng.integers(0, V, size=len(a))
    keep = a != b
    edges.append(np.stack([a[keep], b[keep]], axis=1))
    e = np.concatenate(edges)
    return V, e, perm, comm


def test_label_prop_beats_rcm_chunking_on_communities():
    """Measured cut reduction on a non-lattice graph (the gap the
    reference closed with METIS, salt/src/messages.py:591-670)."""
    from numbskull_jax.parallel.partition import label_prop_refine

    V, edges, perm, comm = _planted_communities()
    P = 4
    rcm = balanced_partition(V, edges, P)
    lp = label_prop_refine(V, edges, rcm, P)
    cut_rcm = edge_cut(edges, rcm)
    cut_lp = edge_cut(edges, lp)
    assert cut_lp < 0.6 * cut_rcm, (cut_rcm, cut_lp)
    # balance preserved
    sizes = np.bincount(lp, minlength=P)
    assert sizes.max() <= 1.06 * V / P + 1
    # and choose_partition's menu picks a refined candidate
    part, report = choose_partition(V, edges, P)
    assert report["chosen"] in ("lp", "cc+lp"), report
    assert edge_cut(edges, part) <= cut_lp * 1.05


def test_label_prop_never_worse_on_random_regular():
    """On an expander-like random graph no partitioner finds a small
    cut, but refinement must never lose to the chunking it started
    from, and must keep balance."""
    from numbskull_jax.parallel.partition import label_prop_refine

    rng = np.random.default_rng(7)
    V = 512
    e = np.stack([rng.permutation(V), rng.permutation(V)], 1)
    edges = np.concatenate([e, np.stack([rng.permutation(V),
                                         rng.permutation(V)], 1)])
    edges = edges[edges[:, 0] != edges[:, 1]]
    P = 4
    rcm = balanced_partition(V, edges, P)
    lp = label_prop_refine(V, edges, rcm, P)
    assert edge_cut(edges, lp) <= edge_cut(edges, rcm)
    sizes = np.bincount(lp, minlength=P)
    assert sizes.max() <= 1.06 * V / P + 1


def test_label_prop_preserves_zero_cut():
    """Refining an already-perfect (zero-cut) partition must not break
    it."""
    from numbskull_jax.models import coin_model
    from numbskull_jax.parallel.partition import label_prop_refine

    w, v, f, fm, dm, e = coin_model(40, evidence=True)
    edges = conflict_edges(v, f, fm)
    part, report = choose_partition(len(v), edges, 4)
    assert edge_cut(edges, part) == 0
    lp = label_prop_refine(len(v), edges, part, 4)
    assert edge_cut(edges, lp) == 0
