"""Chromatic Gibbs sweep and SGD learning sweep (single device).

Device replacement for the reference's hogwild thread kernels
(reference: numbskull/inference.py:10-33 ``gibbsthread`` and
numbskull/learning.py:12-125 ``learnthread``/``sample_and_sgd``). One sweep
= one pass over all variables, executed color by color: within a color no
two variables share a factor, so the whole color block samples as one
fused vectorized step — exact Gibbs, unlike the reference's racing
threads (the stationary distribution matches; per-sample trajectories are
a proper chain here).

Learning follows the reference's expectation–conjugate-descent scheme:
a clamped ("evidence") chain and a free chain are advanced together and
the weight gradient is the difference of factor evaluations between them
(reference: numbskull/learning.py:46-125). Per-sample hogwild weight
writes become a per-color segment-sum by weightId; L2 shrinkage is applied
as factor^(updates) and L1 truncated-gradient (Langford et al.) as a
single stochastic application with matched expectation per color step.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from numbskull_jax.compile import CompiledGraph
from numbskull_jax.ops.factor_eval import eval_factors, present_types_of
from numbskull_jax.ops.sample import draw
from numbskull_jax.types import EV_EVIDENCE, EV_QUERY

# evidence codes as device-friendly ints
_EV_Q = EV_QUERY
_EV_E = EV_EVIDENCE


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SamplerState:
    """Mutable sampler state (a pytree; device-resident)."""

    var_value: jax.Array        # (V,) int32 free-chain values
    var_value_evid: jax.Array   # (V,) int32 clamped-chain values
    weight_value: jax.Array     # (W,) float32
    count: jax.Array            # (V, K) int32 marginal tallies


@dataclasses.dataclass(frozen=True)
class LearnParams:
    """Static learning hyperparameters (hashable; triggers re-jit)."""

    regularization: int = 2     # 0 none, 1 L1 truncated gradient, 2 L2
    reg_param: float = 0.01
    truncation: int = 1
    learn_non_evidence: bool = False
    # 'mean': stable mini-batch mean gradient per color step (default).
    # 'sum':  reference-faithful aggregate movement (hogwild sum); matches
    #         the reference's per-epoch convergence rate on small graphs
    #         but can overshoot at reference stepsizes on large ones.
    grad_agg: str = "mean"


def stack_plans(plans, n_vars: int):
    """Pad per-color plans to common shapes and stack on a leading color
    axis, so the sweep is a `lax.scan` over colors instead of an
    unrolled loop — compile time O(1) in color count (high-degree
    graphs easily need 50+ colors, e.g. the voting experiment family).
    """
    import numpy as np  # host-side

    C = len(plans)
    R = max(p.n_rows for p in plans)
    I = max(p.n_items for p in plans)
    A = max(p.amax for p in plans)

    def pad_cv(get, fill, dtype):
        out = np.full((C, R), fill, dtype)
        for c, p in enumerate(plans):
            out[c, :p.n_rows] = get(p)
        return out

    def pad_it(get, fill, dtype, extra=()):
        out = np.full((C, I) + extra, fill, dtype)
        for c, p in enumerate(plans):
            v = get(p)
            if extra:
                out[c, :p.n_items, :v.shape[1]] = v
            else:
                out[c, :p.n_items] = v
        return out

    stacked = dict(
        cv_vid=pad_cv(lambda p: p.cv_vid, 0, np.int32),
        cv_card=pad_cv(lambda p: p.cv_card, 1, np.int32),
        cv_isev=pad_cv(lambda p: p.cv_isev, 4, np.int32),
        cv_valid=pad_cv(lambda p: p.cv_valid, False, bool),
        it_row=pad_it(lambda p: p.it_row, R - 1, np.int32),
        it_ftype=pad_it(lambda p: p.it_ftype, -1, np.int32),
        it_wid=pad_it(lambda p: p.it_wid, 0, np.int32),
        it_fv=pad_it(lambda p: p.it_fv, 0, np.float32),
        it_dense=pad_it(lambda p: p.it_dense, False, bool),
        it_d1=pad_it(lambda p: p.it_d1, 0, np.int32),
        it_d2=pad_it(lambda p: p.it_d2, 0, np.int32),
        it_valid=pad_it(lambda p: p.it_valid, False, bool),
        it_arity=pad_it(lambda p: p.it_arity, 1, np.int32),
        it_args_vid=pad_it(lambda p: p.it_args_vid, 0, np.int32, (A,)),
        it_args_eq=pad_it(lambda p: p.it_args_eq, 0, np.int32, (A,)),
        it_args_valid=pad_it(lambda p: p.it_args_valid, False, bool,
                             (A,)),
        it_args_card=pad_it(lambda p: p.it_args_card, 1, np.int32, (A,)),
        it_subst=pad_it(lambda p: p.it_subst, False, bool, (A,)),
    )
    # pad rows in it_row must target the dummy row of EVERY color; the
    # dummy row (R-1) is cv_valid=False everywhere by the padding above.
    # scatter-safe variable ids: pad rows -> n_vars (dropped)
    stacked["cv_scatter"] = np.where(stacked["cv_valid"],
                                     stacked["cv_vid"],
                                     n_vars).astype(np.int32)
    return {k: jnp.asarray(v) for k, v in stacked.items()}


# ---- padded row-major fast path (inference) -------------------------------
#
# The flat work-item layout above needs a scatter-add segment_sum per
# color (the per-row potential reduction) and a scatter for the value
# update. The padded layout removes both:
#   * items live at (color, row, slot) — the per-row reduction is a dense
#     axis sum in a fixed order, no segment_sum;
#   * variables are renumbered color-contiguously, so the per-color value
#     update is a dynamic_update_slice, no scatter;
#   * argument-value gathers skip substituted slots (the active variable's
#     own occurrences need no lookup) and read the permuted state with one
#     plain gather.
# Falls back to the flat path when a hub row would blow up the padding.

PADDED_DMAX = 256          # max items per (row, color) before fallback
PADDED_BLOWUP = 4.0        # max padded/flat item ratio before fallback


@dataclasses.dataclass(frozen=True)
class PaddedMeta:
    """Static shape/strategy info for the padded path (hashable)."""

    C: int          # colors
    R: int          # rows per color (uniform, padded)
    D: int          # item slots per row
    A: int          # argument slots per item
    Ag: int         # gathered (non-substituted) argument slots
    Vp: int         # internal permuted state length (multiple of 1024)
    compact: bool   # Ag < A: reconstruct args via g_place selects


def stack_plans_padded(plans, n_vars: int):
    """Build the (C, R, D[, A]) padded layout + color-contiguous variable
    permutation. Returns (device_dict, PaddedMeta) or None when the
    graph is outside the layout's envelope (hub rows, pathological
    padding, or a non-partitioning coloring)."""
    if not plans or n_vars == 0:
        return None
    C = len(plans)
    R = max(p.n_rows for p in plans)
    A = max(p.amax for p in plans)
    counts_all, tot_items = [], 0
    D = 1
    for p in plans:
        rows = p.it_row[p.it_valid]
        cnt = np.bincount(rows, minlength=p.n_rows)
        counts_all.append(cnt)
        if cnt.size:
            D = max(D, int(cnt.max()))
        tot_items += int(p.it_valid.sum())
    if D > PADDED_DMAX:
        return None
    if C * R * D > max(PADDED_BLOWUP * max(tot_items, 1), 1 << 16):
        return None

    # color-contiguous permutation: internal pos = c*R + row
    pos_of = np.full(n_vars, -1, np.int64)
    Vp = _round_up(C * R, 1024)
    src_of = np.full(Vp, n_vars, np.int64)      # dummy -> sentinel slot
    for c, p in enumerate(plans):
        vids = p.cv_vid[p.cv_valid]
        rs = np.nonzero(p.cv_valid)[0]
        if (pos_of[vids] != -1).any():
            return None                          # var in two colors
        pos_of[vids] = c * R + rs
        src_of[c * R + rs] = vids
    if (pos_of < 0).any():
        return None                              # uncolored variable

    sh_i = (C, R, D)
    sh_a = (C, R, D, A)
    out = dict(
        it_ftype=np.full(sh_i, -1, np.int32),
        it_wid=np.zeros(sh_i, np.int32),
        it_fv=np.zeros(sh_i, np.float32),
        it_dense=np.zeros(sh_i, bool),
        it_d1=np.zeros(sh_i, np.int32),
        it_d2=np.zeros(sh_i, np.int32),
        it_valid=np.zeros(sh_i, bool),
        it_arity=np.ones(sh_i, np.int32),
        it_args_pos=np.zeros(sh_a, np.int32),    # internal (permuted)
        it_args_eq=np.zeros(sh_a, np.int32),
        it_args_valid=np.zeros(sh_a, bool),
        it_args_card=np.ones(sh_a, np.int32),
        it_subst=np.zeros(sh_a, bool),
        cv_vid=np.zeros((C, R), np.int32),       # original ids (ext_pot)
        cv_card=np.ones((C, R), np.int32),
        cv_isev=np.full((C, R), 4, np.int32),
        cv_valid=np.zeros((C, R), bool),
    )
    for c, p in enumerate(plans):
        v = p.it_valid
        rows = p.it_row[v]
        # slot within row via running count (items are row-grouped)
        starts = np.concatenate(([0], np.cumsum(counts_all[c])))
        order = np.argsort(rows, kind="stable")
        slot = np.empty(len(rows), np.int64)
        slot[order] = np.arange(len(rows)) - starts[rows[order]]
        ix = (c, rows, slot)
        out["it_ftype"][ix] = p.it_ftype[v]
        out["it_wid"][ix] = p.it_wid[v]
        out["it_fv"][ix] = p.it_fv[v]
        out["it_dense"][ix] = p.it_dense[v]
        out["it_d1"][ix] = p.it_d1[v]
        out["it_d2"][ix] = p.it_d2[v]
        out["it_valid"][ix] = True
        out["it_arity"][ix] = p.it_arity[v]
        Ac = p.it_args_vid.shape[1]
        av = p.it_args_valid[v]
        vid_safe = np.where(av, p.it_args_vid[v], 0)
        out["it_args_pos"][c, rows, slot, :Ac] = np.where(
            av, pos_of[vid_safe], 0)
        out["it_args_eq"][c, rows, slot, :Ac] = p.it_args_eq[v]
        out["it_args_valid"][c, rows, slot, :Ac] = av
        out["it_args_card"][c, rows, slot, :Ac] = p.it_args_card[v]
        out["it_subst"][c, rows, slot, :Ac] = p.it_subst[v]
        out["cv_vid"][c, :p.n_rows] = p.cv_vid
        out["cv_card"][c, :p.n_rows] = p.cv_card
        out["cv_isev"][c, :p.n_rows] = p.cv_isev
        out["cv_valid"][c, :p.n_rows] = p.cv_valid

    # gather compaction: substituted / invalid slots need no value lookup
    need = out["it_args_valid"] & ~out["it_subst"]
    Ag = max(int(need.sum(-1).max()) if need.size else 0, 1)
    compact = A <= 4 and Ag < A
    if compact:
        j = np.cumsum(need, axis=-1) - 1
        out["g_place"] = np.where(need, j, -1).astype(np.int32)
        # scatter each needed arg position into its gather slot
        g_idx = np.zeros((C, R, D, Ag), np.int32)
        cc, rr, dd, aa = np.nonzero(need)
        g_idx[cc, rr, dd, j[cc, rr, dd, aa]] = \
            out["it_args_pos"][cc, rr, dd, aa]
        out["g_idx"] = g_idx
    else:
        Ag = A
        out["g_idx"] = out["it_args_pos"]
    del out["it_args_pos"]

    meta = PaddedMeta(C=C, R=R, D=D, A=A, Ag=Ag, Vp=Vp, compact=compact)
    dev = {k: jnp.asarray(v) for k, v in out.items()}
    # per-run permutation helpers (kept beside the plan arrays):
    # pos_of: orig vid -> internal pos; src_of: internal pos -> orig vid
    # (sentinel n_vars for pad slots, resolved against a 0-extended state)
    dev["pos_of"] = jnp.asarray(pos_of.astype(np.int32))
    dev["src_of"] = jnp.asarray(src_of.astype(np.int32))
    return dev, meta


#: per-color arrays of the padded plan (leading color axis)
_PADDED_COLOR_KEYS = ("g_idx", "g_place", "it_ftype", "it_fv", "it_dense",
                      "it_d1", "it_d2", "it_valid", "it_arity",
                      "it_args_eq", "it_args_valid", "it_args_card",
                      "it_subst", "cv_vid", "cv_card", "cv_isev",
                      "cv_valid")


def _padded_color_arrays(pp) -> dict:
    return {k: pp[k] for k in _PADDED_COLOR_KEYS if k in pp}


def _to_padded(pp, x, fill):
    """A per-variable (V,) array in the permuted padded order (Vp,);
    pad slots read ``fill``."""
    xx = jnp.concatenate([x, jnp.full((1,), fill, x.dtype)])
    return xx[pp["src_of"]]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _gather_padded(xp, idx):
    """Argument values from the permuted state at static-shape indices."""
    return xp[idx]


def _args_from_gather(pp, g, meta: PaddedMeta):
    """(R, D, A) argument values from the compacted gather (R, D, Ag)."""
    if not meta.compact:
        return g
    vals = jnp.zeros(pp["it_subst"].shape, jnp.int32)
    for j in range(meta.Ag):
        vals = jnp.where(pp["g_place"] == j, g[..., j:j + 1], vals)
    return vals


def padded_color_potentials(pp, meta: PaddedMeta, kmax, present, xp,
                            w_it, ext_pot=None):
    """Potentials (R, kmax) of one color block in the padded layout.

    ``pp`` holds one color's slice of the padded plan arrays, ``xp`` the
    permuted state and ``w_it`` the (R, D) weight of every item slot.
    Same semantics as ``color_potentials`` (reference
    numbskull/inference.py:55-71), summed per row in slot order."""
    g = _gather_padded(xp, pp["g_idx"])
    vals = _args_from_gather(pp, g, meta)                 # (R, D, A)
    ks = jnp.arange(kmax, dtype=jnp.int32)
    sub = jnp.where(pp["it_subst"][:, :, None, :],
                    ks[None, None, :, None],
                    vals[:, :, None, :])                  # (R, D, K, A)
    e = eval_factors(pp["it_ftype"][:, :, None], sub,
                     pp["it_args_eq"][:, :, None, :],
                     pp["it_args_valid"][:, :, None, :],
                     pp["it_args_card"][:, :, None, :],
                     pp["it_arity"][:, :, None], present)  # (R, D, K)
    card = pp["cv_card"]
    ok = jnp.where(pp["it_dense"][:, :, None],
                   ks[None, None, :] < card[:, None, None],
                   (ks[None, None, :] == pp["it_d1"][:, :, None]) |
                   (ks[None, None, :] == pp["it_d2"][:, :, None]))
    contrib = jnp.where(ok & pp["it_valid"][:, :, None],
                        w_it[:, :, None] * e, 0.0)
    pot = jnp.sum(contrib, axis=1)                        # (R, K)
    if ext_pot is not None:
        pot = pot + ext_pot[pp["cv_vid"]][:, :kmax]
    return pot


def _color_step_infer_padded(pp, ci, meta: PaddedMeta, kmax, present,
                             sample_evidence, xp, w_it, key,
                             ext_pot=None):
    """Resample one color block in the padded layout."""
    R = meta.R
    old = jax.lax.dynamic_slice(xp, (ci * R,), (R,))
    pot = padded_color_potentials(pp, meta, kmax, present, xp, w_it,
                                  ext_pot)
    card = pp["cv_card"]
    new = draw(pot, card, key)
    isev = pp["cv_isev"]
    upd = pp["cv_valid"] & ((isev == _EV_Q) |
                            (sample_evidence & (isev == _EV_E)))
    out = jnp.where(upd, new, old)
    return jax.lax.dynamic_update_slice(xp, out, (ci * R,))


def _plan_device_arrays(plan, n_vars: int):
    """Device-resident dict view of a ColorPlan (+ scatter-safe vids)."""
    scatter_vid = np.where(plan.cv_valid, plan.cv_vid, n_vars)
    return dict(
        cv_vid=jnp.asarray(plan.cv_vid),
        cv_scatter=jnp.asarray(scatter_vid.astype(np.int32)),
        cv_card=jnp.asarray(plan.cv_card),
        cv_isev=jnp.asarray(plan.cv_isev),
        cv_valid=jnp.asarray(plan.cv_valid),
        it_row=jnp.asarray(plan.it_row),
        it_ftype=jnp.asarray(plan.it_ftype),
        it_wid=jnp.asarray(plan.it_wid),
        it_fv=jnp.asarray(plan.it_fv),
        it_dense=jnp.asarray(plan.it_dense),
        it_d1=jnp.asarray(plan.it_d1),
        it_d2=jnp.asarray(plan.it_d2),
        it_valid=jnp.asarray(plan.it_valid),
        it_arity=jnp.asarray(plan.it_arity),
        it_args_vid=jnp.asarray(plan.it_args_vid),
        it_args_eq=jnp.asarray(plan.it_args_eq),
        it_args_valid=jnp.asarray(plan.it_args_valid),
        it_args_card=jnp.asarray(plan.it_args_card),
        it_subst=jnp.asarray(plan.it_subst),
    )


def color_potentials(pd, kmax: int, present, var_value, weight_value,
                     ext_pot=None):
    """Potentials (R, kmax) for one color's variables, all values at once.

    Equivalent to looping reference potential() (numbskull/inference.py:55-71)
    over every variable of the color and every candidate value; featureValue
    is deliberately absent (the reference omits it during inference too).

    ``ext_pot``: optional (V, K) external unary potentials added per
    variable — the receiver side of boundary potential messages in
    partitioned execution (the generalization of the reference's UFO
    values, salt/src/messages.py:1069-1079 apply_ufo_values).
    """
    vals = var_value[pd["it_args_vid"]]                       # (I, A)
    ks = jnp.arange(kmax, dtype=jnp.int32)                    # (K,)
    sub = jnp.where(pd["it_subst"][:, None, :],
                    ks[None, :, None], vals[:, None, :])      # (I, K, A)
    e = eval_factors(pd["it_ftype"][:, None], sub,
                     pd["it_args_eq"][:, None, :],
                     pd["it_args_valid"][:, None, :],
                     pd["it_args_card"][:, None, :],
                     pd["it_arity"][:, None], present)        # (I, K)
    w = weight_value[pd["it_wid"]]                            # (I,)
    row_card = pd["cv_card"][pd["it_row"]]                    # (I,)
    contrib_ok = jnp.where(pd["it_dense"][:, None],
                           ks[None, :] < row_card[:, None],
                           (ks[None, :] == pd["it_d1"][:, None]) |
                           (ks[None, :] == pd["it_d2"][:, None]))
    contrib = jnp.where(contrib_ok & pd["it_valid"][:, None],
                        w[:, None] * e, 0.0)
    R = pd["cv_card"].shape[0]
    pot = jax.ops.segment_sum(contrib, pd["it_row"], num_segments=R)
    if ext_pot is not None:
        pot = pot + ext_pot[pd["cv_vid"]][:, :kmax]
    return pot


def _color_step_infer(pd, kmax, present, sample_evidence,
                      var_value, weight_value, key, ext_pot=None):
    """Resample one color block of the free chain."""
    pot = color_potentials(pd, kmax, present, var_value, weight_value,
                           ext_pot)
    new = draw(pot, pd["cv_card"], key)
    isev = pd["cv_isev"]
    upd = pd["cv_valid"] & ((isev == _EV_Q) |
                            (sample_evidence & (isev == _EV_E)))
    old = var_value[pd["cv_vid"]]
    out = jnp.where(upd, new, old)
    return var_value.at[pd["cv_scatter"]].set(out, mode="drop")


def _eval_items_at(pd, present, chain, value_it):
    """Evaluate each work item's factor with its active var at value_it."""
    vals = chain[pd["it_args_vid"]]
    sub = jnp.where(pd["it_subst"], value_it[:, None], vals)
    return eval_factors(pd["it_ftype"], sub, pd["it_args_eq"],
                        pd["it_args_valid"], pd["it_args_card"],
                        pd["it_arity"], present)


def _color_step_learn(pd, kmax, present, lp: LearnParams, n_weights,
                      weight_fixed, var_init,
                      var_value, var_value_evid, weight_value,
                      step, key, ext_pot=None, ext_pot_evid=None):
    """One color block of the dual-chain SGD sweep."""
    key_e, key_p, key_t = jax.random.split(key, 3)
    isev = pd["cv_isev"]
    valid = pd["cv_valid"]

    # clamped chain: evidence vars pinned at initialValue, others sampled
    pot_e = color_potentials(pd, kmax, present, var_value_evid, weight_value,
                             ext_pot if ext_pot_evid is None
                             else ext_pot_evid)
    e_samp = draw(pot_e, pd["cv_card"], key_e)
    init_here = var_init[pd["cv_vid"]]
    e_val = jnp.where(isev == _EV_E, init_here, e_samp)

    # free chain: always sampled
    pot_p = color_potentials(pd, kmax, present, var_value, weight_value,
                             ext_pot)
    p_val = draw(pot_p, pd["cv_card"], key_p)

    upd = valid & (isev != 4)
    old_e = var_value_evid[pd["cv_vid"]]
    old_p = var_value[pd["cv_vid"]]
    e_val = jnp.where(upd, e_val, old_e)
    p_val = jnp.where(upd, p_val, old_p)

    # gradient = (eval at proposal on free chain) - (eval at evidence on
    # clamped chain), per adjacent factor (reference learning.py:100-109)
    e_it = e_val[pd["it_row"]]
    p_it = p_val[pd["it_row"]]
    ev_e = _eval_items_at(pd, present, var_value_evid, e_it)
    ev_p = _eval_items_at(pd, present, var_value, p_it)

    slot_hit = (pd["it_d1"] == e_it) | (pd["it_d1"] == p_it) | \
               (pd["it_d2"] == e_it) | (pd["it_d2"] == p_it)
    include = pd["it_valid"] & (pd["it_dense"] | slot_hit)
    if lp.learn_non_evidence:
        vmask = upd
    else:
        vmask = valid & (isev == _EV_E)
    include &= vmask[pd["it_row"]]
    include &= ~weight_fixed[pd["it_wid"]]

    grad = jnp.where(include, (ev_p - ev_e) * pd["it_fv"], 0.0)
    gw = jax.ops.segment_sum(grad, pd["it_wid"], num_segments=n_weights)
    nw = jax.ops.segment_sum(include.astype(jnp.float32), pd["it_wid"],
                             num_segments=n_weights)

    # Mini-batch semantics: the reference applies nw sequential per-sample
    # updates whose later gradients self-correct (learning.py:111-125); a
    # batched sum cannot, and diverges at reference-scale stepsizes on
    # large graphs. Default is the MEAN gradient per color step — standard
    # stable mini-batch SGD with noise shrinking as 1/sqrt(batch); 'sum'
    # reproduces the reference's aggregate per-epoch movement.
    touched = nw > 0
    if lp.grad_agg == "mean":
        gw = gw / jnp.maximum(nw, 1.0)

    w = weight_value
    if lp.regularization == 2:
        shrink = 1.0 / (1.0 + lp.reg_param * step)
        w = jnp.where(touched, w * shrink - step * gw, w)
    elif lp.regularization == 1:
        w = jnp.where(touched, w - step * gw, w)
        # truncated gradient (Langford et al. 2009), reference
        # learning.py:115-122: coin with prob 1/truncation, magnitude
        # reg_param * step * truncation — applied once per color step
        u = jax.random.uniform(key_t, w.shape)
        l1delta = lp.reg_param * step * lp.truncation
        w_trunc = jnp.where(w > 0, jnp.maximum(0.0, w - l1delta),
                            jnp.minimum(0.0, w + l1delta))
        w = jnp.where(touched & (u < 1.0 / lp.truncation), w_trunc, w)
    else:
        w = jnp.where(touched, w - step * gw, w)

    var_value = var_value.at[pd["cv_scatter"]].set(p_val, mode="drop")
    var_value_evid = var_value_evid.at[pd["cv_scatter"]].set(
        e_val, mode="drop")
    return var_value, var_value_evid, w


class GibbsEngine:
    """Single-device chromatic Gibbs sampler over a CompiledGraph.

    All epoch loops run on-device (``lax.fori_loop``); epoch counts are
    dynamic so changing them never recompiles.
    """

    #: the sweep compiles as a lax.scan over uniformly padded color plans
    #: by default, so compile time does not grow with the color count.
    #: Unrolling (scan_colors=False) only pays off for very unbalanced
    #: color sizes, where uniform padding wastes compute.
    SCAN_THRESHOLD = 1

    def __init__(self, cg: CompiledGraph, scan_colors: bool | None = None,
                 padded: bool | None = None):
        self.cg = cg
        self.kmax = cg.kmax
        self.n_vars = cg.n_vars
        self.n_weights = cg.n_weights
        self.plans = [_plan_device_arrays(p, cg.n_vars) for p in cg.plans]
        self.plan_kmax = [p.kmax for p in cg.plans]
        self.present = [present_types_of(p.it_ftype) for p in cg.plans]
        self.present_all = tuple(sorted(
            {t for pr in self.present for t in pr}))
        self.scan_colors = (len(cg.plans) >= self.SCAN_THRESHOLD
                            if scan_colors is None else scan_colors)
        if self.scan_colors:
            self.stacked = stack_plans(cg.plans, cg.n_vars)
        # padded row-major inference path (see above)
        self.padded = self.padded_meta = None
        if padded is not False:
            built = stack_plans_padded(cg.plans, cg.n_vars)
            if built is not None:
                self.padded, self.padded_meta = built
        self.var_card = jnp.asarray(cg.var_card)
        self.var_isev = jnp.asarray(cg.var_isev)
        self.var_init = jnp.asarray(cg.var_init)
        self.weight_fixed = jnp.asarray(cg.weight_fixed)
        self._jit_cache = {}

    # ---- state -----------------------------------------------------------

    def init_state(self) -> SamplerState:
        v0 = jnp.asarray(self.cg.var_init)
        return SamplerState(
            var_value=v0,
            var_value_evid=v0,
            weight_value=jnp.asarray(self.cg.weight_init),
            count=jnp.zeros((self.n_vars, self.kmax), jnp.int32),
        )

    # ---- sweeps ----------------------------------------------------------
    # NOTE: plan arrays / var metadata are threaded through as jit ARGUMENTS
    # (never closed over) — closed-over jax.Arrays embed as HLO constants
    # and bloat the executable for large graphs.

    def _sweep_infer(self, plans, sample_evidence, var_value, weight_value,
                     key, ext_pot=None):
        if self.scan_colors:
            def step(vv, xs):
                pd, ci = xs
                vv = _color_step_infer(
                    pd, self.kmax, self.present_all, sample_evidence,
                    vv, weight_value, jax.random.fold_in(key, ci), ext_pot)
                return vv, None
            C = len(self.plan_kmax)
            var_value, _ = jax.lax.scan(
                step, var_value, (plans, jnp.arange(C)))
            return var_value
        for i, pd in enumerate(plans):
            var_value = _color_step_infer(
                pd, self.plan_kmax[i], self.present[i], sample_evidence,
                var_value, weight_value, jax.random.fold_in(key, i),
                ext_pot)
        return var_value

    def _tally(self, var_isev, sample_evidence, count, var_value):
        mask = (var_isev == _EV_Q) | (sample_evidence & (var_isev == _EV_E))
        ks = jnp.arange(self.kmax, dtype=jnp.int32)
        onehot = (var_value[:, None] == ks[None, :]) & mask[:, None]
        return count + onehot.astype(jnp.int32)

    def _run_infer(self, plans, var_isev, state: SamplerState, key, burn,
                   epochs, sample_evidence: bool, ext_pot=None,
                   epoch_offset=0):
        def burn_body(i, carry):
            vv, k = carry
            vv = self._sweep_infer(plans, sample_evidence, vv,
                                   state.weight_value,
                                   jax.random.fold_in(k, i), ext_pot)
            return vv, k

        def epoch_body(i, carry):
            # keys are folded at the ABSOLUTE epoch index (i + offset) so
            # a run chunked at any boundary (e.g. checkpoint_every) is
            # bit-identical to one uninterrupted run
            vv, cnt, k = carry
            vv = self._sweep_infer(plans, sample_evidence, vv,
                                   state.weight_value,
                                   jax.random.fold_in(
                                       k, i + epoch_offset + (1 << 20)),
                                   ext_pot)
            cnt = self._tally(var_isev, sample_evidence, cnt, vv)
            return vv, cnt, k

        vv, _ = jax.lax.fori_loop(0, burn, burn_body, (state.var_value, key))
        vv, cnt, _ = jax.lax.fori_loop(0, epochs, epoch_body,
                                       (vv, state.count, key))
        return dataclasses.replace(state, var_value=vv, count=cnt)

    def _run_infer_padded(self, pp, var_isev, state: SamplerState, key,
                          burn, epochs, sample_evidence: bool,
                          ext_pot=None, epoch_offset=0):
        """Padded-layout inference run: permute into color-contiguous
        space once, sweep/tally there, permute back once."""
        meta = self.padded_meta
        kmax = self.kmax
        C = meta.C
        xp = _to_padded(pp, state.var_value, 0)
        w_it = state.weight_value[pp["it_wid"]]     # hoisted: one gather
        isev_p = _to_padded(pp, var_isev, 4)
        mask_p = (isev_p == _EV_Q) | (sample_evidence & (isev_p == _EV_E))
        scan_pp = _padded_color_arrays(pp)

        def sweep(xp, k):
            def cstep(xp, xs):
                spp, wit, ci = xs
                xp = _color_step_infer_padded(
                    spp, ci, meta, kmax, self.present_all,
                    sample_evidence, xp, wit,
                    jax.random.fold_in(k, ci), ext_pot)
                return xp, None
            xp, _ = jax.lax.scan(
                cstep, xp, (scan_pp, w_it, jnp.arange(C)))
            return xp

        def burn_body(i, carry):
            xp, k = carry
            return sweep(xp, jax.random.fold_in(k, i)), k

        ks = jnp.arange(kmax, dtype=jnp.int32)

        def epoch_body(i, carry):
            xp, cnt_p, k = carry
            xp = sweep(xp, jax.random.fold_in(
                k, i + epoch_offset + (1 << 20)))
            onehot = (xp[:, None] == ks[None, :]) & mask_p[:, None]
            return xp, cnt_p + onehot.astype(jnp.int32), k

        xp, _ = jax.lax.fori_loop(0, burn, burn_body, (xp, key))
        cnt_p0 = jnp.zeros((meta.Vp, kmax), jnp.int32)
        xp, cnt_p, _ = jax.lax.fori_loop(0, epochs, epoch_body,
                                         (xp, cnt_p0, key))
        vv = xp[pp["pos_of"]]
        cnt = state.count + cnt_p[pp["pos_of"]]
        return dataclasses.replace(state, var_value=vv, count=cnt)

    def _padded_potentials(self, pp, var_value, weight_value):
        meta = self.padded_meta
        xp = _to_padded(pp, var_value, 0)

        def color(xs):
            spp, wit = xs
            return padded_color_potentials(spp, meta, self.kmax,
                                           self.present_all, xp, wit)
        pot = jax.lax.map(color, (_padded_color_arrays(pp),
                                  weight_value[pp["it_wid"]]))
        return pot.reshape(meta.C * meta.R, self.kmax)[pp["pos_of"]]

    def _run_learn(self, plans, weight_fixed, var_init, state: SamplerState,
                   key, burn, epochs, step0, decay, lp: LearnParams,
                   ext_pot=None, ext_pot_evid=None):
        def burn_body(i, carry):
            vv, k = carry
            vv = self._sweep_infer(plans, True, vv, state.weight_value,
                                   jax.random.fold_in(k, i), ext_pot)
            return vv, k

        def epoch_body(i, carry):
            vv, ve, w, k = carry
            ek = jax.random.fold_in(k, i + (1 << 20))
            step = step0 * jnp.power(decay, i.astype(jnp.float32))
            if self.scan_colors:
                def cstep(carry, xs):
                    vv, ve, w = carry
                    pd, ci = xs
                    out = _color_step_learn(
                        pd, self.kmax, self.present_all, lp,
                        self.n_weights, weight_fixed, var_init,
                        vv, ve, w, step, jax.random.fold_in(ek, ci),
                        ext_pot, ext_pot_evid)
                    return out, None
                C = len(self.plan_kmax)
                (vv, ve, w), _ = jax.lax.scan(
                    cstep, (vv, ve, w), (plans, jnp.arange(C)))
            else:
                for ci, pd in enumerate(plans):
                    vv, ve, w = _color_step_learn(
                        pd, self.plan_kmax[ci], self.present[ci], lp,
                        self.n_weights, weight_fixed, var_init,
                        vv, ve, w, step, jax.random.fold_in(ek, ci),
                        ext_pot, ext_pot_evid)
            return vv, ve, w, k

        vv, _ = jax.lax.fori_loop(0, burn, burn_body, (state.var_value, key))
        vv, ve, w, _ = jax.lax.fori_loop(
            0, epochs, epoch_body,
            (vv, state.var_value_evid, state.weight_value, key))
        return dataclasses.replace(state, var_value=vv, var_value_evid=ve,
                                   weight_value=w)

    # ---- public API ------------------------------------------------------

    def _get_jit(self, name, fn, static):
        if name not in self._jit_cache:
            self._jit_cache[name] = jax.jit(fn, static_argnames=static)
        return self._jit_cache[name]

    def inference(self, state: SamplerState, key, epochs: int,
                  burn: int = 0, sample_evidence: bool = True,
                  ext_pot=None, epoch_offset: int = 0) -> SamplerState:
        """Burn in, then run `epochs` tallying sweeps of the free chain.

        ``ext_pot``: optional (V, K) external unary potentials (boundary
        messages in partitioned execution). ``epoch_offset``: absolute
        index of the first epoch (chunked/checkpointed runs pass their
        progress so the per-epoch keys continue the same sequence)."""
        if self.padded is not None:
            fn = self._get_jit("infer_padded", self._run_infer_padded,
                               ("sample_evidence",))
            return fn(self.padded, self.var_isev, state, key,
                      jnp.int32(burn), jnp.int32(epochs),
                      sample_evidence=sample_evidence, ext_pot=ext_pot,
                      epoch_offset=jnp.int32(epoch_offset))
        fn = self._get_jit("infer", self._run_infer, ("sample_evidence",))
        plans = self.stacked if self.scan_colors else self.plans
        return fn(plans, self.var_isev, state, key,
                  jnp.int32(burn), jnp.int32(epochs),
                  sample_evidence=sample_evidence, ext_pot=ext_pot,
                  epoch_offset=jnp.int32(epoch_offset))

    def learn(self, state: SamplerState, key, epochs: int, stepsize: float,
              decay: float = 1.0, burn: int = 0,
              lp: LearnParams = LearnParams(), ext_pot=None,
              ext_pot_evid=None) -> SamplerState:
        """Dual-chain SGD weight learning (burn-in samples evidence)."""
        fn = self._get_jit("learn", self._run_learn, ("lp",))
        plans = self.stacked if self.scan_colors else self.plans
        return fn(plans, self.weight_fixed, self.var_init, state, key,
                  jnp.int32(burn), jnp.int32(epochs),
                  jnp.float32(stepsize), jnp.float32(decay), lp=lp,
                  ext_pot=ext_pot, ext_pot_evid=ext_pot_evid)

    def padded_potentials(self, state: SamplerState) -> jax.Array:
        """(V, kmax) potentials of every variable at ``state``, computed
        by the padded layout's color step (every color reads the same
        state; nothing is sampled). Requires the padded path."""
        fn = self._get_jit("potentials_padded", self._padded_potentials,
                           ())
        return fn(self.padded, state.var_value, state.weight_value)

    def marginals(self, state: SamplerState, epochs: int) -> np.ndarray:
        """(V, K) marginal estimates = count / epochs."""
        return np.asarray(state.count) / float(max(epochs, 1))
