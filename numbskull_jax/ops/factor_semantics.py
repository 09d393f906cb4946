"""Single source of truth for the 25 factor-function semantics.

Factors are evaluated in two steps:

1. compute a small set of argument STATISTICS (counts of zeros/ones,
   eq-matches, head-matches, the first three argument values, the head
   value) with masked reductions over a padded argument axis
   (ops/factor_eval.py);

2. call :func:`finalize` below, which maps (factor code, stats) to the
   factor value — the ONLY place the per-type truth table lives.

Parity target: golden.eval_factor (reference numbskull/inference.py:
149-413), including the intentional deviations documented in golden.py
(head read through the head variable's value for the IMPLY family).
Adding factor type 26 means adding one stat (if needed) and one entry
here.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from numbskull_jax import types as T


@dataclasses.dataclass
class ArgStats:
    """Argument statistics of one (batch of) factor evaluation(s).

    All fields broadcast against each other; counts are int, values are
    int (cast to float by finalize). ``body`` = positions < arity-1.
    """

    n_zero: object        # sum over valid args of [v == 0]
    n_one: object         # sum over valid args of [v == 1]
    n_diff0: object       # sum over valid args of [v != v0]
    n_head_eq: object     # sum over BODY args of [v == head]
    n_body_zero: object   # sum over BODY args of [v == 0]
    n_neq_eq: object      # sum over valid args of [v != eq]
    n_eq_eq: object       # sum over valid args of [v == eq]
    n_body_neq_eq: object  # sum over BODY args of [v != eq]
    head: object          # value of arg at position arity-1
    head_eq: object       # dense_equal_to at position arity-1
    v0: object            # value of arg 0
    v1: object            # value of arg 1 (0 when absent)
    v2: object            # value of arg 2 (0 when absent)
    card0: object         # cardinality of arg 0's variable
    card1: object         # cardinality of arg 1's variable
    ufo_sel: object       # value of arg at position v0-1 (0 if v0 == 0)


def finalize(present, ftype, st: ArgStats):
    """Map factor codes + ArgStats to factor values.

    ``present``: static iterable of factor codes possibly present —
    absent types generate no code. ``ftype``: int array of codes
    (NOOP/padding yields 0). Returns float32.
    """
    f32 = jnp.float32
    one, neg, zero = f32(1), f32(-1), f32(0)
    head = st.head
    out = zero * jnp.asarray(ftype).astype(f32)
    for t in present:
        if t == T.FUNC_NOOP:
            val = out * 0
        elif t == T.FUNC_IMPLY_NATURAL:
            val = jnp.where(st.n_zero > 0, zero,
                            jnp.where(head != 0, one, neg))
        elif t == T.FUNC_OR:
            val = jnp.where(st.n_one > 0, one, neg)
        elif t == T.FUNC_EQUAL:
            val = jnp.where(st.n_diff0 > 0, neg, one)
        elif t in (T.FUNC_AND, T.FUNC_ISTRUE):
            val = jnp.where(st.n_zero > 0, neg, one)
        elif t == T.FUNC_LINEAR:
            val = jnp.asarray(st.n_head_eq).astype(f32)
        elif t == T.FUNC_RATIO:
            val = jnp.log1p(jnp.asarray(st.n_head_eq).astype(f32))
        elif t == T.FUNC_LOGICAL:
            val = jnp.where(st.n_head_eq > 0, one, zero)
        elif t == T.FUNC_IMPLY_MLN:
            # golden.py:84-87 head truthiness (the old kernel eval
            # returned the raw head value here — equal for boolean
            # heads, wrong for categorical heads >= 2)
            val = jnp.where(st.n_body_zero > 0, one,
                            jnp.where(head != 0, one, zero))
        elif t in (T.FUNC_AND_CAT, T.FUNC_EQUAL_CAT_CONST):
            val = jnp.where(st.n_neq_eq > 0, zero, one)
        elif t == T.FUNC_OR_CAT:
            val = jnp.where(st.n_eq_eq > 0, one, neg)
        elif t == T.FUNC_IMPLY_NATURAL_CAT:
            val = jnp.where(st.n_body_neq_eq > 0, zero,
                            jnp.where(head == st.head_eq, one, neg))
        elif t == T.FUNC_IMPLY_MLN_CAT:
            val = jnp.where(st.n_body_neq_eq > 0, one,
                            jnp.where(head == st.head_eq, one, zero))
        elif t == T.FUNC_DP_GEN_CLASS_PRIOR:
            val = jnp.where(st.v0 == 1, one, neg)
        elif t == T.FUNC_DP_GEN_LF_PRIOR:
            val = jnp.where(st.v0 == 2, neg,
                            jnp.where(st.v0 == 0, zero, one))
        elif t == T.FUNC_DP_GEN_LF_PROPENSITY:
            val = jnp.where(st.v0 == st.card0 - 1, zero, one)
        elif t == T.FUNC_DP_GEN_LF_ACCURACY:
            val = jnp.where(st.v1 == st.card1 - 1, zero,
                            jnp.where(st.v0 == st.v1, one, neg))
        elif t == T.FUNC_DP_GEN_LF_CLASS_PROPENSITY:
            val = jnp.where(st.v1 == st.card1 - 1, zero,
                            jnp.where(st.v0 == 1, one, neg))
        elif t == T.FUNC_DP_GEN_DEP_FIXING:
            y, l1, l2 = st.v0, st.v1, st.v2
            ab = jnp.where(l1 == st.card1 - 1,
                           jnp.where(l2 != 1, neg, zero), zero)
            hit = ((l1 == 0) & (l2 == 1) & (y == 1)) | \
                  ((l1 == 1) & (l2 == 0) & (y == 0))
            val = jnp.where(l1 == st.card1 - 1, ab,
                            jnp.where(hit, one, zero))
        elif t == T.FUNC_DP_GEN_DEP_REINFORCING:
            y, l1, l2 = st.v0, st.v1, st.v2
            ab = jnp.where(l1 == st.card1 - 1,
                           jnp.where(l2 != 1, neg, zero), zero)
            hit = ((l1 == 0) & (l2 == 0) & (y == 0)) | \
                  ((l1 == 1) & (l2 == 1) & (y == 1))
            val = jnp.where(l1 == st.card1 - 1, ab,
                            jnp.where(hit, one, zero))
        elif t == T.FUNC_DP_GEN_DEP_EXCLUSIVE:
            ab = st.card0 - 1
            val = jnp.where((st.v0 == ab) | (st.v1 == ab), zero, neg)
        elif t == T.FUNC_DP_GEN_DEP_SIMILAR:
            val = jnp.where(st.v0 == st.v1, one, zero)
        elif t == T.FUNC_UFO:
            # distributed-support factor: value of the arg at position
            # v0-1, or 0 when v0 == 0 (reference inference.py:398-405)
            val = jnp.where(st.v0 == 0, zero,
                            jnp.asarray(st.ufo_sel).astype(f32))
        else:  # pragma: no cover - planner guards unknown codes
            val = out * 0
        out = jnp.where(jnp.asarray(ftype) == jnp.int32(t), val, out)
    return out
