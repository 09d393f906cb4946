"""Graph compiler: attachment semantics, coloring validity, item packing."""

import numpy as np

from numbskull_jax import golden
from numbskull_jax import types as T
from numbskull_jax.compile import (
    build_attachments, color_variables, compile_graph, conflict_edges,
)
from numbskull_jax.models import ising_grid, lf_model


def _random_graph(rng, n_vars=12, n_factors=20, cat_frac=0.4):
    v = T.new_variables(n_vars)
    is_cat = rng.random(n_vars) < cat_frac
    v["dataType"] = is_cat.astype(np.int16)
    v["cardinality"] = np.where(is_cat, rng.integers(2, 5, n_vars), 2)
    v["isEvidence"] = rng.integers(0, 2, n_vars)
    w = T.new_weights(3)
    w["initialValue"] = rng.normal(size=3)
    arities = rng.integers(1, 4, n_factors)
    f = T.new_factors(n_factors)
    f["factorFunction"] = T.FUNC_OR
    f["weightId"] = rng.integers(0, 3, n_factors)
    f["featureValue"] = 1.0
    f["arity"] = arities
    f["ftv_offset"] = np.concatenate(([0], np.cumsum(arities)[:-1]))
    E = int(arities.sum())
    fm = T.new_fmap(E)
    fm["vid"] = rng.integers(0, n_vars, E)
    for j in range(E):
        fm["dense_equal_to"][j] = rng.integers(
            0, v["cardinality"][fm["vid"][j]])
    return w, v, f, fm


def test_attachments_match_golden_slots():
    rng = np.random.default_rng(7)
    w, v, f, fm = _random_graph(rng)
    att_f, att_v, att_d = build_attachments(v, f, fm)
    att = set(zip(att_f.tolist(), att_v.tolist(), att_d.tolist()))
    for vid in range(len(v)):
        if v["dataType"][vid] == 0:
            want = golden.slot_factors(v, f, fm, vid, 0)
            got = sorted(a[0] for a in att if a[1] == vid)
            assert got == want, vid
        else:
            for val in range(int(v["cardinality"][vid])):
                want = golden.slot_factors(v, f, fm, vid, val)
                got = sorted(a[0] for a in att
                             if a[1] == vid and a[2] == val)
                assert got == want, (vid, val)


def test_factors_to_skip():
    rng = np.random.default_rng(8)
    w, v, f, fm = _random_graph(rng)
    skip = np.array([0, 5, 19], np.int64)
    att_f, _, _ = build_attachments(v, f, fm, factors_to_skip=skip)
    assert not set(skip.tolist()) & set(att_f.tolist())


def test_coloring_proper():
    rng = np.random.default_rng(9)
    w, v, f, fm = _random_graph(rng, n_vars=40, n_factors=80)
    edges = conflict_edges(v, f, fm)
    color = color_variables(len(v), edges)
    assert (color >= 0).all()
    for (a, b) in edges:
        assert color[a] != color[b]


def test_ising_two_colors():
    w, v, f, fm, dm, e = ising_grid(8, 8)
    hint = (np.arange(64) // 8 + np.arange(64) % 8) % 2
    cg = compile_graph(w, v, f, fm, domain_mask=dm, color_hint=hint)
    assert cg.n_colors == 2
    # without a hint, peeling should stay near-greedy (grid degree 4)
    cg2 = compile_graph(w, v, f, fm, domain_mask=dm)
    assert cg2.n_colors <= 5
    # every variable appears exactly once across color plans
    seen = np.concatenate([p.cv_vid[p.cv_valid] for p in cg.plans])
    assert sorted(seen.tolist()) == list(range(64))
    # every (factor, var) attachment appears: EQUAL factors have 2 vars
    n_items = sum(int(p.it_valid.sum()) for p in cg.plans)
    assert n_items == 2 * cg.n_factors


def test_bipartite_coloring_grid_and_odd_cycle():
    from numbskull_jax.compile import bipartite_coloring

    # 4x4 grid: bipartite -> 2 colors, no conflicts
    n = 4
    edges = []
    for i in range(n):
        for j in range(n):
            v = i * n + j
            if i:
                edges.append((v, v - n))
            if j:
                edges.append((v, v - 1))
    e = np.array(edges)
    c = bipartite_coloring(16, e)
    assert c is not None and c.max() == 1
    assert (c[e[:, 0]] != c[e[:, 1]]).all()

    # triangle: odd cycle -> not bipartite
    tri = np.array([[0, 1], [1, 2], [2, 0]])
    assert bipartite_coloring(3, tri) is None


def test_reduce_colors_preserves_validity():
    from numbskull_jax.compile import color_variables, reduce_colors

    rng = np.random.default_rng(5)
    n = 200
    e = rng.integers(0, n, (600, 2))
    e = e[e[:, 0] != e[:, 1]]
    c0 = color_variables(n, e)
    c1 = reduce_colors(c0, e)
    assert c1.max() <= c0.max()
    assert (c1[e[:, 0]] != c1[e[:, 1]]).all()


def test_max_colors_cap():
    w, v, f, fm, dm, e = ising_grid(6, 6)
    cg = compile_graph(w, v, f, fm, domain_mask=dm, max_colors=1)
    assert cg.n_colors == 1


def test_item_dedup_multi_position():
    """A var appearing twice in one factor yields ONE work item
    (compute_var_map dedup, reference dataloading.py:67-81)."""
    w = T.new_weights(1)
    v = T.new_variables(2)
    v["cardinality"] = 2
    f = T.new_factors(1)
    f["factorFunction"] = T.FUNC_OR
    f["arity"] = 3
    fm = T.new_fmap(3)
    fm["vid"] = [0, 0, 1]
    cg = compile_graph(w, v, f, fm)
    n_items = sum(int(p.it_valid.sum()) for p in cg.plans)
    assert n_items == 2  # (f,0) once, (f,1) once
    # substitution mask marks both positions of var 0
    for p in cg.plans:
        for i in range(p.n_items):
            if p.it_valid[i] and p.cv_vid[p.it_row[i]] == 0:
                assert p.it_subst[i, :3].sum() == 2


def test_lf_model_compiles():
    args = lf_model(0.5, [1.0, 0.5], copies=4)
    cg = compile_graph(*args[:4], domain_mask=args[4])
    assert cg.kmax == 3
    assert cg.n_colors == 2  # y vs its LF neighbors


def test_voting_grouped_structure_and_coloring():
    """The reference's intro-degree family (copies = n_vars//degree
    disjoint groups, one AND factor of arity degree+1): greedy-in-RCM
    coloring uses exactly degree+1 colors aligned across groups, and
    the padded layout is single-slot (every variable in exactly one
    factor)."""
    from numbskull_jax.models import voting_grouped
    from numbskull_jax.ops import GibbsEngine

    w, v, f, fm, dm, e = voting_grouped(3000, 7, weight=0.3)
    assert len(f) == 3000 // 7
    assert (f["arity"] == 8).all()
    cg = compile_graph(w, v, f, fm, domain_mask=dm)
    assert cg.n_colors == 8
    # disjoint groups: each group's 8 vars get 8 distinct colors
    colors = cg.color_of.reshape(-1, 8)
    assert all(len(set(row)) == 8 for row in colors[:5])
    meta = GibbsEngine(cg).padded_meta
    assert meta is not None
    assert meta.D == 1 and meta.A == 8
