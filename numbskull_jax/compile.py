"""Graph compiler: lower a factor graph to device-ready color plans.

This is the device-first replacement for the reference's CSR construction
(reference: numbskull/dataloading.py:16-81 ``compute_var_map``) *and* its
hogwild thread sharding (reference: numbskull/factorgraph.py:13-24). Instead
of an inverse index walked one variable at a time by racing threads, we:

1. build the deduplicated (factor, variable, slot) attachment relation with
   vectorized numpy (same semantics as ``compute_var_map``: one adjacency
   slot per dataType==0 variable, one per dense value for dataType==1;
   duplicate (slot, factor) pairs collapsed; ``factors_to_skip`` honored);

2. color the variable conflict graph (vars sharing a factor get different
   colors) by parallel maximal-independent-set peeling, so each color is a
   set of variables whose Gibbs updates are conditionally independent —
   the correctness-preserving replacement for hogwild threads;

3. pack, per color, a flat static-shaped SoA "work item" table: one item
   per (factor, variable) pair carrying the factor's argument lists,
   substitution masks and slot values, sorted by target row so potential
   accumulation is a segment-sum. Items do double duty for inference
   (potentials per candidate value) and learning (gradient terms).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

_INT = np.int32

_CORE = None


def _compilecore():
    """ctypes handle to the native compile core, if built (make -C
    native libcompilecore.so); None otherwise (numpy pipeline runs).
    Override the path with NUMBSKULL_JAX_COMPILECORE; set it to "off"
    to force the numpy pipeline."""
    global _CORE
    if _CORE is not None:
        return _CORE or None
    override = os.environ.get("NUMBSKULL_JAX_COMPILECORE", "")
    if override == "off":
        _CORE = False
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    native_dir = os.path.join(here, "..", "native")
    so_path = os.path.join(native_dir, "libcompilecore.so")
    if (not override and not os.path.isfile(so_path)
            and os.path.isfile(os.path.join(native_dir, "Makefile"))):
        _build_native(native_dir)
    candidates = [override, so_path]
    for path in candidates:
        if path and os.path.isfile(path):
            lib = _load_native(
                path, native_dir if path == so_path else None)
            if lib is None:
                continue
            lib.compile_count.restype = ctypes.c_int64
            lib.compile_fill.restype = ctypes.c_int
            lib.greedy_color.restype = ctypes.c_int64
            lib.dump_rows.restype = ctypes.c_int
            lib.dump_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            # round-3 entry points (guarded: a stale .so without them
            # still serves the older fast paths)
            if hasattr(lib, "conflict_count"):
                lib.conflict_count.restype = ctypes.c_int64
                lib.rcm_rank.restype = ctypes.c_int
            if hasattr(lib, "color_graph"):
                lib.color_graph.restype = ctypes.c_int64
                lib.conflict_pairs.restype = ctypes.c_int64
            if hasattr(lib, "compile_count2"):
                lib.compile_count2.restype = ctypes.c_int64
                lib.compile_fill3.restype = ctypes.c_int
            _CORE = lib
            return lib
    _CORE = False
    return None


def _build_native(native_dir: str) -> None:
    """Build the gitignored native helpers once, under an exclusive
    lock so concurrent builders do not interleave; any failure (no
    make/compiler, read-only tree) is swallowed — callers fall back to
    the numpy pipeline, and _load_native re-checks the result."""
    import subprocess
    try:
        import fcntl
        with open(os.path.join(native_dir, ".build.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            subprocess.run(["make", "-C", native_dir, "-s"],
                           check=False, capture_output=True)
    except OSError:
        pass


def _load_native(path: str, native_dir: str | None = None):
    """dlopen with one locked rebuild retry: a reader racing a builder
    (or a truncated .so from an interrupted build) gets a fresh link
    under the lock instead of a crash; returns None when the library
    still cannot load."""
    try:
        return ctypes.CDLL(path)
    except OSError:
        if native_dir is None:
            return None
    _build_native(native_dir)
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _pad_to(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


@dataclasses.dataclass
class ColorPlan:
    """Static per-color device data (all numpy, padded)."""

    color: int
    kmax: int                 # max cardinality among this color's variables
    amax: int                 # max arity among this color's factors
    # --- variables of this color (R = padded row count) ---
    cv_vid: np.ndarray        # (R,) global variable id; pad rows -> 0
    cv_card: np.ndarray       # (R,) cardinality; pad -> 1
    cv_isev: np.ndarray       # (R,) evidence code 0/1/4; pad -> 4
    cv_valid: np.ndarray      # (R,) bool
    # --- work items (I = padded item count) ---
    it_row: np.ndarray        # (I,) row index into this color's vars; pad -> R-1
    it_ftype: np.ndarray      # (I,) factor function code
    it_wid: np.ndarray        # (I,) weight id
    it_fv: np.ndarray         # (I,) featureValue (learning only)
    it_dense: np.ndarray      # (I,) bool: active var has dataType==0
    it_d1: np.ndarray         # (I,) first slot value
    it_d2: np.ndarray         # (I,) second slot value (== d1 if single slot)
    it_valid: np.ndarray      # (I,) bool
    it_arity: np.ndarray      # (I,)
    it_args_vid: np.ndarray   # (I, A) global var ids of factor args
    it_args_eq: np.ndarray    # (I, A) dense equal-to values
    it_args_valid: np.ndarray  # (I, A) bool
    it_args_card: np.ndarray  # (I, A) cardinality of each arg variable
    it_subst: np.ndarray      # (I, A) bool: arg is the active variable

    @property
    def n_rows(self) -> int:
        return len(self.cv_vid)

    @property
    def n_items(self) -> int:
        return len(self.it_row)


@dataclasses.dataclass
class CompiledGraph:
    """A factor graph lowered to per-color SoA plans."""

    plans: list[ColorPlan]
    n_vars: int
    n_weights: int
    n_factors: int
    kmax: int
    var_init: np.ndarray      # (V,) densified initial values (int32)
    var_card: np.ndarray      # (V,) int32
    var_isev: np.ndarray      # (V,) int32 evidence codes
    var_dtype: np.ndarray     # (V,) int32 dataType
    weight_init: np.ndarray   # (W,) float32
    weight_fixed: np.ndarray  # (W,) bool
    color_of: np.ndarray      # (V,) color assignment
    # host-side metadata for DimmWitted-format dumps
    vtf_offset: np.ndarray    # (V,) int64
    vmap_value: np.ndarray    # (num_vtf,) original domain values
    # plan-cache identity of the compile inputs (set when the disk plan
    # cache is active); downstream planners (itemgrid) key their own
    # cached artifacts on it
    cache_key: str | None = None

    @property
    def n_colors(self) -> int:
        return len(self.plans)


def build_attachments(variables, factors, fmap, factors_to_skip=None):
    """Deduplicated (factor, vid, slot-value) attachment triples.

    Semantics of reference compute_var_map (numbskull/dataloading.py:16-81):
    dataType==0 vars use slot 0 regardless of value; dataType==1 vars use
    the dense_equal_to slot; duplicates within a slot collapse.
    """
    F = len(factors)
    arity = factors["arity"].astype(np.int64)
    edge_fid = np.repeat(np.arange(F, dtype=np.int64), arity)
    if factors_to_skip is not None and len(factors_to_skip):
        keep = np.ones(F, bool)
        keep[np.asarray(factors_to_skip, dtype=np.int64)] = False
        edge_keep = keep[edge_fid]
        edge_fid = edge_fid[edge_keep]
        edge_vid = fmap["vid"][edge_keep].astype(np.int64)
        edge_eq = fmap["dense_equal_to"][edge_keep].astype(np.int64)
    else:
        edge_vid = fmap["vid"].astype(np.int64)
        edge_eq = fmap["dense_equal_to"].astype(np.int64)

    dense = variables["dataType"][edge_vid] == 0
    slot = np.where(dense, 0, edge_eq)

    order = np.lexsort((slot, edge_vid, edge_fid))
    f, v, d = edge_fid[order], edge_vid[order], slot[order]
    if len(f):
        first = np.ones(len(f), bool)
        first[1:] = (f[1:] != f[:-1]) | (v[1:] != v[:-1]) | (d[1:] != d[:-1])
        f, v, d = f[first], v[first], d[first]
    return f, v, d


def conflict_edges(variables, factors, fmap, factors_to_skip=None,
                   dedup: int = 4 << 20):
    """Unordered variable pairs co-occurring in a factor (u <= w).

    Deduplicated only below ``dedup`` pairs: every consumer (coloring,
    CC labels, RCM, partition cost ratios) is correct with duplicate
    edges, and the dedup sort is the most expensive single step of
    compiling a 10M-variable graph.
    """
    F = len(factors)
    arity = factors["arity"].astype(np.int64)
    offs = factors["ftv_offset"].astype(np.int64)
    keep = np.ones(F, bool)
    if factors_to_skip is not None and len(factors_to_skip):
        keep[np.asarray(factors_to_skip, dtype=np.int64)] = False
    core = _compilecore()
    if (core is not None and hasattr(core, "conflict_count")
            and hasattr(core, "conflict_pairs") and F):
        keep8 = np.ascontiguousarray(keep.astype(np.uint8))
        total = int(core.conflict_count(ctypes.c_int64(F), _ptr(arity),
                                        _ptr(keep8)))
        if total >= 0:          # -1: arity beyond the native buffer
            fmap_c = np.ascontiguousarray(fmap)
            vid_off = fmap_c.dtype.fields["vid"][1]
            e = np.empty((max(total, 1), 2), np.int64)
            m = int(core.conflict_pairs(
                ctypes.c_int64(F), _ptr(arity), _ptr(offs),
                ctypes.c_void_p(fmap_c.ctypes.data + vid_off),
                ctypes.c_int64(fmap_c.dtype.itemsize), _ptr(keep8),
                _ptr(e)))
            e = e[:m]
            if len(e) <= dedup:
                e = np.unique(e, axis=0)
            return e
    pairs = []
    for a in np.unique(arity):
        a = int(a)
        if a < 2:
            continue
        sel = keep & (arity == a)
        if not sel.any():
            continue
        idx = offs[sel][:, None] + np.arange(a)
        vids = fmap["vid"][idx].astype(np.int64)    # (n, a)
        iu, ju = np.triu_indices(a, k=1)
        u = vids[:, iu].ravel()
        w = vids[:, ju].ravel()
        ne = u != w
        pairs.append(np.stack([np.minimum(u[ne], w[ne]),
                               np.maximum(u[ne], w[ne])], axis=1))
    if not pairs:
        return np.zeros((0, 2), np.int64)
    e = np.concatenate(pairs, axis=0)
    if len(e) <= dedup:
        e = np.unique(e, axis=0)
    return e


def color_variables(n_vars: int, edges: np.ndarray,
                    max_colors: int | None = None,
                    seed: int = 0) -> np.ndarray:
    """Color variables so no conflict edge is monochromatic.

    Parallel MIS peeling with random priorities (Jones–Plassmann style),
    fully vectorized; each round's winners take the *smallest* color not
    used by an already-colored neighbor, which keeps color counts near
    greedy quality (2 on stars, ~3-4 on grids) while staying O(E) per
    round. If ``max_colors`` is given and peeling would exceed it, the
    remaining variables all share the last color — an explicit opt-in to
    hogwild-style races, mirroring the reference's always-racing
    semantics (numbskull/inference.py:16-18).
    """
    rng = np.random.default_rng(seed)
    prio = rng.permutation(n_vars).astype(np.int64)
    color = np.full(n_vars, -1, np.int64)
    u, w = (edges[:, 0], edges[:, 1]) if len(edges) else \
        (np.zeros(0, np.int64), np.zeros(0, np.int64))
    n_colors = 0
    rounds = 0
    while True:
        uncolored = color < 0
        if not uncolored.any():
            break
        if max_colors is not None and (rounds >= 4 * max_colors or
                                       n_colors >= max_colors):
            color[uncolored] = max(min(n_colors, max_colors) - 1, 0)
            break
        rounds += 1
        # winners: local priority maxima among uncolored neighbors
        live = uncolored[u] & uncolored[w]
        nmax = np.full(n_vars, -1, np.int64)
        if live.any():
            np.maximum.at(nmax, u[live], prio[w[live]])
            np.maximum.at(nmax, w[live], prio[u[live]])
        winners = uncolored & (prio > nmax)
        # smallest color not used by a colored neighbor (winners form an
        # independent set, so they cannot conflict with each other)
        cand = 0
        remaining = winners.copy()
        while remaining.any():
            used = np.zeros(n_vars, bool)
            cu = color[u] == cand
            cw = color[w] == cand
            if cu.any():
                used[w[cu]] = True
            if cw.any():
                used[u[cw]] = True
            take = remaining & ~used
            color[take] = cand
            n_colors = max(n_colors, cand + 1)
            remaining &= ~take
            cand += 1
            if max_colors is not None and cand >= max_colors:
                color[remaining] = max_colors - 1
                n_colors = max_colors
                break
    return color


def fold_attachments(att_f, att_v, att_d):
    """Fold (factor, var, slot) triples — sorted by (f, v, d) — into
    (factor, var) items carrying <=2 slot values (categorical vars attach
    at up to 2 distinct value slots per factor after dedup: its own
    dense_equal_to plus one more via shared factors; reference vmap keeps
    one adjacency list per value, dataloading.py:34-46)."""
    n_t = len(att_f)
    if not n_t:
        z = np.zeros(0, np.int64)
        return z, z, z, z
    new_grp = np.ones(n_t, bool)
    new_grp[1:] = (att_f[1:] != att_f[:-1]) | (att_v[1:] != att_v[:-1])
    grp_id = np.cumsum(new_grp) - 1
    grp_first = np.flatnonzero(new_grp)
    rank = np.arange(n_t) - grp_first[grp_id]
    item_local = rank // 2
    grp_sizes = np.diff(np.append(grp_first, n_t))
    items_per_grp = (grp_sizes + 1) // 2
    item_off = np.concatenate(([0], np.cumsum(items_per_grp)[:-1]))
    trip_item = item_off[grp_id] + item_local
    n_items_all = int(items_per_grp.sum())

    item_f = np.zeros(n_items_all, np.int64)
    item_v = np.zeros(n_items_all, np.int64)
    item_d1 = np.zeros(n_items_all, np.int64)
    item_f[trip_item] = att_f
    item_v[trip_item] = att_v
    even = rank % 2 == 0
    item_d1[trip_item[even]] = att_d[even]
    item_d2 = item_d1.copy()
    item_d2[trip_item[~even]] = att_d[~even]
    return item_f, item_v, item_d1, item_d2


def pack_item_block(variables, factors, fmap, item_f, item_v,
                    item_d1, item_d2, row_of_item,
                    R: int, item_pad: int = 128):
    """Pack selected (factor, var) items into the static SoA it_* arrays
    (rows indexed by ``row_of_item``; pad items target dummy row R-1)."""
    arity_all = factors["arity"].astype(np.int64)
    ftv_all = factors["ftv_offset"].astype(np.int64)
    fmap_vid = fmap["vid"].astype(np.int64)
    fmap_eq = fmap["dense_equal_to"].astype(np.int64)
    var_card = variables["cardinality"].astype(np.int64)
    var_dtype = variables["dataType"].astype(np.int64)

    n_it = len(item_f)
    amax = int(arity_all[item_f].max()) if n_it else 1
    I = _pad_to(n_it, item_pad)

    it = dict(
        it_row=np.full(I, R - 1, _INT),
        it_ftype=np.full(I, -1, _INT),            # NOOP padding
        it_wid=np.zeros(I, _INT),
        it_fv=np.zeros(I, np.float32),
        it_dense=np.zeros(I, bool),
        it_d1=np.zeros(I, _INT),
        it_d2=np.zeros(I, _INT),
        it_valid=np.zeros(I, bool),
        it_arity=np.ones(I, _INT),
        it_args_vid=np.zeros((I, amax), _INT),
        it_args_eq=np.zeros((I, amax), _INT),
        it_args_valid=np.zeros((I, amax), bool),
        it_args_card=np.ones((I, amax), _INT),
        it_subst=np.zeros((I, amax), bool),
    )
    if n_it:
        fs, vs = item_f, item_v
        it["it_row"][:n_it] = row_of_item
        it["it_ftype"][:n_it] = factors["factorFunction"][fs]
        it["it_wid"][:n_it] = factors["weightId"][fs]
        it["it_fv"][:n_it] = factors["featureValue"][fs]
        it["it_dense"][:n_it] = var_dtype[vs] == 0
        it["it_d1"][:n_it] = item_d1
        it["it_d2"][:n_it] = item_d2
        it["it_valid"][:n_it] = True
        ar = arity_all[fs]
        it["it_arity"][:n_it] = ar
        pos = np.arange(amax)
        valid = pos[None, :] < ar[:, None]
        eidx = np.minimum(ftv_all[fs][:, None] + pos, len(fmap_vid) - 1)
        avid = np.where(valid, fmap_vid[eidx], 0)
        it["it_args_vid"][:n_it] = avid
        it["it_args_eq"][:n_it] = np.where(valid, fmap_eq[eidx], 0)
        it["it_args_valid"][:n_it] = valid
        it["it_args_card"][:n_it] = np.where(valid, var_card[avid], 1)
        it["it_subst"][:n_it] = valid & (avid == vs[:, None])
    return it, amax


def cc_labels(n: int, u: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Connected-component labels (consistent ids; NOT guaranteed to be
    the min vertex of the component).

    scipy's compiled union-find when available (C speed at 10M+ vars);
    otherwise min-label hooking + full pointer jumping (Shiloach–
    Vishkin style): every round is vectorized numpy over the edge list,
    label distances doubling per round.
    """
    parent = np.arange(n, dtype=np.int64)
    if not len(u):
        return parent
    u = np.asarray(u, np.int64)
    w = np.asarray(w, np.int64)
    try:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components
        idt = np.int32 if n < 2 ** 31 else np.int64
        g = coo_matrix((np.ones(len(u), np.int8),
                        (u.astype(idt), w.astype(idt))), shape=(n, n))
        # weak connectivity on the directed graph equals undirected
        # components and skips scipy's explicit symmetrization pass
        _, labels = connected_components(g, directed=True,
                                         connection="weak")
        return labels.astype(np.int64)
    except ImportError:      # pragma: no cover - scipy is baked in
        pass
    while True:
        pu, pw = parent[u], parent[w]
        live = pu != pw
        if not live.any():
            return parent
        # drop settled edges: most of a mesh settles within a few
        # rounds, so later rounds touch a shrinking edge set
        u, w, pu, pw = u[live], w[live], pu[live], pw[live]
        np.minimum.at(parent, pu, pw)
        np.minimum.at(parent, pw, pu)
        while True:                       # full path compression
            pp = parent[parent]
            if (pp == parent).all():
                break
            parent = pp


def rcm_rank(n_vars: int, edges_u: np.ndarray,
             edges_v: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee-style bandwidth-reducing rank.

    Fully vectorized (no per-vertex/per-edge Python): CSR by argsort,
    one min-degree seed per connected component, level-synchronous
    multi-seed BFS, final order = lexsort by (component, BFS level,
    degree) — the King variant of CM, reversed. Components stay
    contiguous so their neighborhoods never interleave. Shared by the
    itemgrid kernel's window layout and balanced partitioning.
    """
    u = np.asarray(edges_u, np.int64)
    w = np.asarray(edges_v, np.int64)
    core = _compilecore()
    if core is not None and hasattr(core, "rcm_rank"):
        uc = np.ascontiguousarray(u)
        wc = np.ascontiguousarray(w)
        rank = np.empty(n_vars, np.int64)
        rc = int(core.rcm_rank(ctypes.c_int64(n_vars),
                               ctypes.c_int64(len(uc)), _ptr(uc),
                               _ptr(wc), _ptr(rank)))
        if rc == 0:
            return rank
    src = np.concatenate([u, w])
    dst = np.concatenate([w, u])
    adj = dst[np.argsort(src, kind="stable")]
    deg = np.bincount(src, minlength=n_vars)
    offs = np.concatenate(([0], np.cumsum(deg)))

    comp = cc_labels(n_vars, u, w)
    # one min-degree seed per component (first of each comp group)
    sord = np.lexsort((deg, comp))
    first = np.ones(n_vars, bool)
    if n_vars:
        first[1:] = comp[sord][1:] != comp[sord][:-1]
    seeds = sord[first]

    level = np.full(n_vars, -1, np.int64)
    level[seeds] = 0
    frontier = seeds
    lvl = 0
    while len(frontier):
        cnt = deg[frontier]
        total = int(cnt.sum())
        if not total:
            break
        starts = np.repeat(offs[frontier], cnt)
        idx = starts + (np.arange(total) -
                        np.repeat(np.cumsum(cnt) - cnt, cnt))
        nbrs = adj[idx]
        nbrs = np.unique(nbrs[level[nbrs] < 0])
        lvl += 1
        level[nbrs] = lvl
        frontier = nbrs
    order = np.lexsort((deg, level, comp))
    rank = np.empty(n_vars, np.int64)
    rank[order[::-1]] = np.arange(n_vars)
    return rank


def bipartite_coloring(n_vars: int, edges: np.ndarray):
    """Parity 2-coloring, or None if the conflict graph is odd-cyclic.

    Most pairwise models (lattices, chains, bipartite feature graphs)
    are 2-chromatic; MIS peeling typically wastes 2-3 extra colors on
    them, which costs sweep steps and breaks the itemgrid kernel's
    window locality.

    Fully vectorized via the bipartite double cover: lift each edge
    (u, w) to (u, w') and (u', w) on 2V vertices; the graph is bipartite
    iff v and v' always land in DIFFERENT components, and the side of
    the double-cover component each v fell on IS its parity.
    """
    if not len(edges):
        return None
    u, w = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    comp = cc_labels(2 * n_vars,
                     np.concatenate([u, u + n_vars]),
                     np.concatenate([w + n_vars, w]))
    lo, hi = comp[:n_vars], comp[n_vars:]
    if (lo == hi).any():
        return None                       # odd cycle in some component
    return (lo > hi).astype(np.int64)


def native_coloring(n_vars: int, edges: np.ndarray):
    """One native pass: CSR build + BFS parity 2-coloring, with a
    greedy-in-RCM-order fallback when the graph is odd-cyclic — the
    exact result of bipartite_coloring-else-greedy_coloring, minus the
    ~130 s of numpy double-cover CC + argsort CSR traffic those pay at
    32M conflict pairs on this VM. Returns (color, bipartite) or None
    when the core lacks the entry point."""
    core = _compilecore()
    if core is None or not hasattr(core, "color_graph"):
        return None
    if n_vars == 0:
        return np.zeros(0, np.int64), True
    e = np.ascontiguousarray(np.asarray(edges, np.int64).reshape(-1, 2))
    color = np.empty(n_vars, np.int64)
    nc = int(core.color_graph(ctypes.c_int64(n_vars),
                              ctypes.c_int64(len(e)), _ptr(e),
                              _ptr(color)))
    if nc < 0:
        return None
    return color, nc <= 2


def greedy_coloring(n_vars: int, edges: np.ndarray):
    """Greedy sequential coloring in bandwidth-reduced (RCM) order via
    the native core; None when the core is unavailable.

    Greedy-in-RCM-order colors equivalent local structures with the
    SAME color sequence (e.g. every disjoint voting clique gets colors
    0..k in group order), so color regions stay group-aligned and the
    itemgrid kernel's windows stay contiguous — random-priority MIS
    coloring scatters a clique's colors and destroys window locality.
    Color count is <= max degree + 1 (near-greedy-optimal).
    """
    core = _compilecore()
    if core is None or n_vars == 0:
        return None
    if not len(edges):
        return np.zeros(n_vars, np.int64)
    u = edges[:, 0].astype(np.int64)
    w = edges[:, 1].astype(np.int64)
    src = np.concatenate([u, w])
    dst = np.concatenate([w, u])
    adj = np.ascontiguousarray(dst[np.argsort(src, kind="stable")])
    deg = np.bincount(src, minlength=n_vars)
    offs = np.ascontiguousarray(
        np.concatenate(([0], np.cumsum(deg))).astype(np.int64))
    order = np.ascontiguousarray(
        np.argsort(rcm_rank(n_vars, u, w)).astype(np.int64))
    color = np.full(n_vars, -1, np.int64)
    core.greedy_color(ctypes.c_int64(n_vars), _ptr(offs), _ptr(adj),
                      _ptr(order), _ptr(color))
    return color


def reduce_colors(color: np.ndarray, edges: np.ndarray,
                  rounds: int = 4, seed: int = 0) -> np.ndarray:
    """Greedy color-count reduction (vectorized recoloring).

    MIS peeling can use far more colors than needed (5 on a bipartite
    grid); each round moves an independent set of variables to the
    lowest color absent from their neighborhoods. Never increases the
    color count; converges to near-greedy quality. Fewer colors = fewer
    sweep steps and better window locality for the itemgrid kernel.
    """
    n = len(color)
    if not len(edges) or n == 0 or color.max() >= 63:
        return color
    color = color.copy()
    u, w = edges[:, 0], edges[:, 1]
    rng = np.random.default_rng(seed)
    prio = rng.permutation(n).astype(np.int64)
    for _ in range(rounds):
        mask = np.zeros(n, np.int64)
        np.bitwise_or.at(mask, u, np.int64(1) << color[w])
        np.bitwise_or.at(mask, w, np.int64(1) << color[u])
        # lowest clear bit of mask
        lcb = np.zeros(n, np.int64)
        rem = mask.copy()
        probe = (rem & 1) == 1
        while probe.any():
            lcb[probe] += 1
            rem >>= 1
            probe = probe & ((rem & 1) == 1)
        movers = lcb < color
        if not movers.any():
            break
        # adjacent movers could collide; only local priority maxima move
        live = movers[u] & movers[w]
        nmax = np.full(n, -1, np.int64)
        if live.any():
            np.maximum.at(nmax, u[live], prio[w[live]])
            np.maximum.at(nmax, w[live], prio[u[live]])
        go = movers & (prio > nmax)
        color[go] = lcb[go]
    # densify color ids
    _, dense = np.unique(color, return_inverse=True)
    return dense


def _cv_arrays(cvars, variables, var_card, row_pad: int):
    """Per-color variable-side arrays (shared by both plan builders)."""
    R = _pad_to(len(cvars), row_pad) + 1   # +1 dummy row for item padding
    cv_vid = np.zeros(R, _INT)
    cv_card = np.ones(R, _INT)
    cv_isev = np.full(R, 4, _INT)
    cv_valid = np.zeros(R, bool)
    cv_vid[:len(cvars)] = cvars
    cv_card[:len(cvars)] = var_card[cvars]
    cv_isev[:len(cvars)] = variables["isEvidence"][cvars]
    cv_valid[:len(cvars)] = True
    kmax_c = int(var_card[cvars].max()) if len(cvars) else 1
    return R, kmax_c, dict(cv_vid=cv_vid, cv_card=cv_card,
                           cv_isev=cv_isev, cv_valid=cv_valid)


def _plans_numpy(variables, factors, fmap, factors_to_skip, color,
                 n_colors, var_card, item_pad: int, row_pad: int):
    """Reference numpy plan pipeline (also the native core's oracle)."""
    V = len(variables)
    att_f, att_v, att_d = build_attachments(variables, factors, fmap,
                                            factors_to_skip)
    # fold attachment triples into (factor, var) items with <=2 slots
    item_f, item_v, item_d1, item_d2 = fold_attachments(att_f, att_v, att_d)

    plans = []
    for c in range(n_colors):
        cvars = np.flatnonzero(color == c)
        R, kmax_c, cv = _cv_arrays(cvars, variables, var_card, row_pad)

        # row index of each variable of this color
        row_of = np.zeros(V, np.int64)
        row_of[cvars] = np.arange(len(cvars))

        sel = np.flatnonzero(color[item_v] == c) if len(item_v) else \
            np.zeros(0, np.int64)
        # sort items by target row for segment-sum locality
        sel = sel[np.argsort(row_of[item_v[sel]], kind="stable")]
        it, amax_c = pack_item_block(
            variables, factors, fmap, item_f[sel], item_v[sel],
            item_d1[sel], item_d2[sel], row_of[item_v[sel]],
            R, item_pad=item_pad)

        plans.append(ColorPlan(color=c, kmax=kmax_c, amax=amax_c,
                               **cv, **it))
    return plans


def _plans_native(variables, factors, fmap, factors_to_skip, color,
                  n_colors, var_card, item_pad: int, row_pad: int):
    """Native-core plan pipeline: two sequential C passes build every
    color's item tables in one shared arena (per-color views), exactly
    matching _plans_numpy output (asserted by tests/test_native.py).
    Returns None when the graph exceeds the core's limits (caller
    falls back to numpy)."""
    core = _compilecore()
    V = len(variables)
    F = len(factors)
    if V == 0 or V > 2 ** 31 - 2:
        return None

    # structured arrays are read IN PLACE by the core (base + record
    # stride + per-field offsets) — no astype copies of multi-GB columns
    def _field_offs(arr, names):
        return np.array([arr.dtype.fields[n][1] for n in names], np.int64)

    factors = np.ascontiguousarray(factors)
    fmap = np.ascontiguousarray(fmap)
    variables = np.ascontiguousarray(variables)
    foff = _field_offs(factors, ("factorFunction", "weightId",
                                 "featureValue", "arity", "ftv_offset"))
    moff = _field_offs(fmap, ("vid", "dense_equal_to"))
    voff = _field_offs(variables, ("dataType", "cardinality"))
    fac_stride = ctypes.c_int64(factors.dtype.itemsize)
    fmp_stride = ctypes.c_int64(fmap.dtype.itemsize)
    var_stride = ctypes.c_int64(variables.dtype.itemsize)
    skip = np.zeros(F, np.uint8)
    if factors_to_skip is not None and len(factors_to_skip):
        skip[np.asarray(factors_to_skip, np.int64)] = 1

    # global row ids ordered (color, row-in-color)
    color32 = np.ascontiguousarray(color.astype(np.int64))
    order = np.argsort(color32, kind="stable")
    counts_c = np.bincount(color32, minlength=n_colors).astype(np.int64)
    starts_c = np.concatenate(([0], np.cumsum(counts_c)))
    row_in_color = np.empty(V, np.int32)
    row_in_color[order] = (np.arange(V) -
                           starts_c[color32[order]]).astype(np.int32)
    grow = np.ascontiguousarray(starts_c[color32] + row_in_color)
    row_in_color = np.ascontiguousarray(row_in_color)

    rowcount = np.zeros(V, np.int64)
    amax_out = np.zeros(1, np.int64)
    if hasattr(core, "compile_count2"):
        total = core.compile_count2(
            ctypes.c_int64(F), ctypes.c_int64(V), _ptr(factors),
            fac_stride, _ptr(foff), _ptr(fmap), fmp_stride, _ptr(moff),
            _ptr(variables), var_stride, _ptr(voff), _ptr(skip),
            _ptr(grow), _ptr(rowcount), _ptr(amax_out))
    else:
        total = core.compile_count(
            ctypes.c_int64(F), _ptr(factors), fac_stride, _ptr(foff),
            _ptr(fmap), fmp_stride, _ptr(moff), _ptr(variables),
            var_stride, _ptr(voff), _ptr(skip), _ptr(grow),
            _ptr(rowcount), _ptr(amax_out))
    if total < 0:
        return None
    amax = max(int(amax_out[0]), 1)

    # per-color item extents in one padded arena
    cs = np.concatenate(([0], np.cumsum(rowcount)))
    items_c = cs[starts_c[1:]] - cs[starts_c[:-1]]
    I_c = np.array([_pad_to(int(ic), item_pad) for ic in items_c],
                   np.int64)
    arena_off = np.concatenate(([0], np.cumsum(I_c)))
    I_total = int(arena_off[-1])

    it_row = np.empty(I_total, _INT)
    it_ftype = np.empty(I_total, _INT)
    it_wid = np.empty(I_total, _INT)
    it_fv = np.empty(I_total, np.float32)
    it_dense = np.empty(I_total, np.uint8)
    it_d1 = np.empty(I_total, _INT)
    it_d2 = np.empty(I_total, _INT)
    it_valid = np.empty(I_total, np.uint8)
    it_arity = np.empty(I_total, _INT)
    ag_vid = np.empty((I_total, amax), _INT)
    ag_eq = np.empty((I_total, amax), _INT)
    ag_valid = np.empty((I_total, amax), np.uint8)
    ag_card = np.empty((I_total, amax), _INT)
    ag_subst = np.empty((I_total, amax), np.uint8)

    # per-row fill cursor, shifted so color c starts at its arena base
    adj = (arena_off[:-1] - cs[starts_c[:-1]])
    rowpos = np.ascontiguousarray(cs[:V] + adj[color32[order]])
    if hasattr(core, "compile_fill3"):
        # bucketed packed-AoS scatter + dense per-variable cursors: the
        # random writes stay inside an L3-sized window and the random
        # reads collapse to one 16-byte record per variable
        # (byte-identical output)
        rc = core.compile_fill3(
            ctypes.c_int64(F), ctypes.c_int64(V), _ptr(factors),
            fac_stride, _ptr(foff), _ptr(fmap), fmp_stride, _ptr(moff),
            _ptr(variables), var_stride, _ptr(voff), _ptr(skip),
            _ptr(grow), _ptr(row_in_color), _ptr(rowpos),
            ctypes.c_int64(amax), ctypes.c_int64(I_total),
            _ptr(it_row), _ptr(it_ftype), _ptr(it_wid), _ptr(it_fv),
            _ptr(it_dense), _ptr(it_d1), _ptr(it_d2), _ptr(it_valid),
            _ptr(it_arity), _ptr(ag_vid), _ptr(ag_eq), _ptr(ag_valid),
            _ptr(ag_card), _ptr(ag_subst))
    else:
        rc = core.compile_fill(
            ctypes.c_int64(F), _ptr(factors), fac_stride, _ptr(foff),
            _ptr(fmap), fmp_stride, _ptr(moff), _ptr(variables),
            var_stride, _ptr(voff), _ptr(skip), _ptr(grow),
            _ptr(row_in_color), _ptr(rowpos), ctypes.c_int64(amax),
            _ptr(it_row), _ptr(it_ftype), _ptr(it_wid), _ptr(it_fv),
            _ptr(it_dense), _ptr(it_d1), _ptr(it_d2), _ptr(it_valid),
            _ptr(it_arity), _ptr(ag_vid), _ptr(ag_eq), _ptr(ag_valid),
            _ptr(ag_card), _ptr(ag_subst))
    if rc < 0:
        return None

    plans = []
    for c in range(n_colors):
        cvars = order[starts_c[c]:starts_c[c + 1]]
        R, kmax_c, cv = _cv_arrays(cvars, variables, var_card, row_pad)
        base, ic, Ic = int(arena_off[c]), int(items_c[c]), int(I_c[c])
        pad = slice(base + ic, base + Ic)
        it_row[pad] = R - 1
        it_ftype[pad] = -1
        it_wid[pad] = 0
        it_fv[pad] = 0
        it_dense[pad] = 0
        it_d1[pad] = 0
        it_d2[pad] = 0
        it_valid[pad] = 0
        it_arity[pad] = 1
        ag_vid[pad] = 0
        ag_eq[pad] = 0
        ag_valid[pad] = 0
        ag_card[pad] = 1
        ag_subst[pad] = 0
        sl = slice(base, base + Ic)
        amax_c = int(it_arity[base:base + ic].max()) if ic else 1
        amax_c = min(amax_c, amax)
        plans.append(ColorPlan(
            color=c, kmax=kmax_c, amax=amax_c, **cv,
            it_row=it_row[sl], it_ftype=it_ftype[sl], it_wid=it_wid[sl],
            it_fv=it_fv[sl], it_dense=it_dense[sl].view(bool),
            it_d1=it_d1[sl], it_d2=it_d2[sl],
            it_valid=it_valid[sl].view(bool), it_arity=it_arity[sl],
            it_args_vid=ag_vid[sl, :amax_c], it_args_eq=ag_eq[sl, :amax_c],
            it_args_valid=ag_valid[sl, :amax_c].view(bool),
            it_args_card=ag_card[sl, :amax_c],
            it_subst=ag_subst[sl, :amax_c].view(bool)))
    return plans


def compile_graph(weights, variables, factors, fmap,
                  factors_to_skip=None,
                  max_colors: int | None = None,
                  item_pad: int = 128,
                  row_pad: int = 8,
                  seed: int = 0,
                  domain_values=None,
                  domain_mask=None,
                  color_hint=None,
                  cache: str | None = None) -> CompiledGraph:
    """Lower structured arrays to a CompiledGraph of per-color plans.

    ``color_hint``: optional precomputed coloring (e.g. a model generator
    that knows its structure — parity coloring for grids). Validated
    against the conflict edges; falls back to MIS peeling if invalid.

    ``cache``: optional directory for the disk plan cache (default: the
    NSX_PLAN_CACHE env var); byte-identical inputs reload their compiled
    plans instead of recompiling (see plancache).
    """
    from numbskull_jax import plancache

    if cache is None:
        cache = plancache.default_dir()
    key = None
    if cache:
        key = plancache.graph_key(
            weights, variables, factors, fmap, factors_to_skip,
            max_colors, item_pad, row_pad, seed, domain_values,
            domain_mask, color_hint)
        hit = plancache.load(cache, key)
        if hit is not None:
            hit.cache_key = key
            return hit

    V = len(variables)
    W = len(weights)
    F = len(factors)

    edges = conflict_edges(variables, factors, fmap, factors_to_skip)
    color = None
    if color_hint is not None:
        hint = np.asarray(color_hint, np.int64)
        if len(hint) == V and (
                len(edges) == 0 or
                (hint[edges[:, 0]] != hint[edges[:, 1]]).all()):
            color = hint
    if color is None and (max_colors is None or max_colors >= 2):
        nat = native_coloring(V, edges)
        if nat is not None:
            ncolor, bip = nat
            # greedy results only stand when no color cap was requested
            # (the cap path is the explicit MIS/hogwild opt-in below)
            if bip or max_colors is None:
                color = ncolor
        else:
            color = bipartite_coloring(V, edges)
            if color is None and max_colors is None:
                color = greedy_coloring(V, edges)
    if color is None:
        color = color_variables(V, edges, max_colors=max_colors, seed=seed)
        color = reduce_colors(color, edges, seed=seed)
    n_colors = int(color.max()) + 1 if V else 0

    var_card = variables["cardinality"].astype(np.int64)
    var_dtype = variables["dataType"].astype(np.int64)

    plans = None
    if _compilecore() is not None:
        plans = _plans_native(variables, factors, fmap, factors_to_skip,
                              color, n_colors, var_card,
                              item_pad=item_pad, row_pad=row_pad)
    if plans is None:
        plans = _plans_numpy(variables, factors, fmap, factors_to_skip,
                             color, n_colors, var_card,
                             item_pad=item_pad, row_pad=row_pad)

    # vtf layout for dump mapping (reference numbskull.py:310-317 formula)
    slots = np.where(var_dtype == 0, 1, var_card)
    vtf_offset = np.concatenate(([0], np.cumsum(slots)[:-1])) if V else \
        np.zeros(0, np.int64)
    num_vtf = int(slots.sum())
    if domain_values is not None:
        assert len(domain_values) == num_vtf
        vmap_value = np.asarray(domain_values, np.int64).copy()
        # implicit-domain categoricals: value k at slot k
        implicit = (var_dtype == 1) & ~(domain_mask if domain_mask is not None
                                        else np.zeros(V, bool))
    else:
        vmap_value = np.zeros(num_vtf, np.int64)
        implicit = var_dtype == 1
    for v in np.flatnonzero(implicit):
        vmap_value[vtf_offset[v]:vtf_offset[v] + var_card[v]] = \
            np.arange(var_card[v])

    cg = CompiledGraph(
        plans=plans,
        n_vars=V, n_weights=W, n_factors=F,
        kmax=int(var_card.max()) if V else 1,
        var_init=variables["initialValue"].astype(_INT),
        var_card=var_card.astype(_INT),
        var_isev=variables["isEvidence"].astype(_INT),
        var_dtype=var_dtype.astype(_INT),
        weight_init=weights["initialValue"].astype(np.float32),
        weight_fixed=weights["isFixed"].astype(bool),
        color_of=color,
        vtf_offset=vtf_offset,
        vmap_value=vmap_value,
        cache_key=key,
    )
    if cache and key is not None:
        from numbskull_jax import plancache
        plancache.store(cache, key, cg)
    return cg
