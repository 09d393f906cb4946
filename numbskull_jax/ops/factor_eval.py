"""Vectorized evaluation of all 25 factor functions.

Vectorized replacement for the reference's scalar if/elif chain
(reference: numbskull/inference.py:149-413). Instead of branching per
factor, every work item evaluates as masked reductions over a padded
argument axis; the per-type results are combined with ``jnp.select`` over
only the factor types *statically present* in the graph (the compiler
knows the type set, so absent types cost nothing).

The hypothetical-value substitution trick of the reference
(``value if fmap[l]['vid'] == var_samp else var_value[...]``,
reference numbskull/inference.py:163-165) becomes a masked select over the
argument axis performed by the caller; this module receives the already
substituted argument values.

Intentional deviation (bug fix, see golden.py): IMPLY_MLN /
IMPLY_NATURAL_CAT / IMPLY_MLN_CAT read the head through the head
*variable's* value rather than the reference's out-of-space
``var_value[l]`` slot index (reference numbskull/inference.py:242-243).
"""

from __future__ import annotations

import jax.numpy as jnp

from numbskull_jax import types as T
from numbskull_jax.ops.factor_semantics import ArgStats, finalize


def eval_factors(ftype, vals, eq, valid, card, arity, present_types):
    """Evaluate factors for a batch of work items.

    Computes the shared argument statistics with masked reductions over
    the padded argument axis, then applies the single semantics table
    (ops/factor_semantics.finalize), where the 25-function truth table
    lives.

    Args:
      ftype: (...,) int32 factor-function codes.
      vals:  (..., A) int32 argument values (hypothetical already
             substituted at active-arg positions).
      eq:    (..., A) int32 dense equal-to per argument.
      valid: (..., A) bool argument-padding mask.
      card:  (..., A) int32 cardinality of each argument's variable.
      arity: (...,) int32 true arity (head = argument arity-1).
      present_types: static iterable of factor codes present in the batch.

    Returns:
      (...,) float32 factor values; padding items (ftype==NOOP) yield 0.
    """
    A = vals.shape[-1]
    pos = jnp.arange(A, dtype=jnp.int32)
    head_idx = jnp.maximum(arity - 1, 0)[..., None]
    is_head = pos == head_idx
    body = valid & ~is_head

    head = jnp.take_along_axis(vals, head_idx, axis=-1)[..., 0]
    head_eq = jnp.take_along_axis(eq, head_idx, axis=-1)[..., 0]
    v0 = vals[..., 0]
    uidx = jnp.clip(v0 - 1, 0, A - 1)[..., None]
    ufo_sel = jnp.take_along_axis(vals, uidx, axis=-1)[..., 0].astype(
        jnp.float32)
    st = ArgStats(
        n_zero=(valid & (vals == 0)).sum(-1),
        n_one=(valid & (vals == 1)).sum(-1),
        n_diff0=(valid & (vals != v0[..., None])).sum(-1),
        n_head_eq=(body & (vals == head[..., None])).sum(-1),
        n_body_zero=(body & (vals == 0)).sum(-1),
        n_neq_eq=(valid & (vals != eq)).sum(-1),
        n_eq_eq=(valid & (vals == eq)).sum(-1),
        n_body_neq_eq=(body & (vals != eq)).sum(-1),
        head=head, head_eq=head_eq,
        v0=v0,
        v1=vals[..., 1] if A > 1 else v0 * 0,
        v2=vals[..., 2] if A > 2 else v0 * 0,
        card0=card[..., 0],
        card1=card[..., 1] if A > 1 else card[..., 0],
        ufo_sel=ufo_sel)
    return finalize(present_types, ftype, st)


def present_types_of(ftype_array) -> tuple[int, ...]:
    """Static set of factor codes in a (host) ftype array, NOOP excluded."""
    import numpy as np

    u = np.unique(np.asarray(ftype_array))
    return tuple(int(t) for t in u if t != T.FUNC_NOOP)
