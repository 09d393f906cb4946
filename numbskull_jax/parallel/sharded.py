"""Multi-device Gibbs: chain replication x graph sharding via shard_map.

Device-mesh replacement for the reference's entire distributed stack
(salt master/minion orchestration, TCP msgpack data plane, per-epoch
boundary-variable exchange, master-side weight-delta summation;
reference: salt/src/numbskull_master.py:133-233,
salt/src/numbskull_minion.py:225-280, salt/src/messages.py:1253-1319).

Design — and why it beats the reference's scheme:

* Work items (factor evaluations) are sharded over the ``graph`` mesh
  axis. Each device computes *partial potentials* for one color block
  from its local factors; one ``psum`` over the ``graph`` axis produces the full
  potentials everywhere. All graph-axis devices then draw the SAME sample
  (same counter-based key), so variable values stay replicated with no
  explicit exchange — the psum of a (rows, K) float block *is* the halo
  exchange, fused into the sweep.
* Consequence: results are EXACT synchronous chromatic Gibbs at any
  device count — the reference instead ships one-epoch-stale boundary
  values (an async approximation, SURVEY.md §3.4) and needs PF/UFO
  factor-compression tricks to keep traffic down; a potential psum is
  already the maximally compressed message (one scalar per
  variable-value, the same algebraic reduction UFO performs).
* Chains shard over the ``chains`` axis (the reference's var_copies,
  factorgraph.py:48-53, made into real replica parallelism): tallies are
  summed across chains for marginals; learning gradients are
  ``pmean``-ed across chains like data parallelism; weights stay
  replicated (the reference's master-sums-deltas protocol,
  numbskull_master.py:223-224, becomes one collective).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from numbskull_jax.compile import CompiledGraph
from numbskull_jax.ops.factor_eval import eval_factors
from numbskull_jax.ops.gibbs import (
    GibbsEngine, LearnParams, SamplerState, _EV_E, _EV_Q,
)
from numbskull_jax.ops.sample import draw
from numbskull_jax.parallel.mesh import CHAINS_AXIS, GRAPH_AXIS


def _shard_items(pd: dict, n_graph: int) -> dict:
    """Split a plan's item arrays into n_graph contiguous shards.

    Item order within a plan is sorted by target row; a contiguous split
    keeps each device's segment-sum touching a compact row range.
    Adds a leading axis of size n_graph to it_* arrays; cv_* stay
    replicated.
    """
    out = {}
    for k, v in pd.items():
        if k.startswith("it_"):
            arr = np.asarray(v)
            n = arr.shape[0]
            pad = (-n) % n_graph
            if pad:
                if k == "it_row":
                    fill = np.full((pad,) + arr.shape[1:],
                                   pd["cv_card"].shape[0] - 1, arr.dtype)
                elif k == "it_ftype":
                    fill = np.full((pad,) + arr.shape[1:], -1, arr.dtype)
                else:
                    fill = np.zeros((pad,) + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, fill], axis=0)
            out[k] = jnp.asarray(
                arr.reshape((n_graph, arr.shape[0] // n_graph) +
                            arr.shape[1:]))
        else:
            out[k] = jnp.asarray(v)
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedState:
    """Sampler state with a leading chains axis.

    var arrays: (C, V) sharded over chains; weights: (W,) replicated;
    count: (C, V, K) sharded over chains.
    """

    var_value: jax.Array
    var_value_evid: jax.Array
    weight_value: jax.Array
    count: jax.Array


class ShardedGibbsEngine:
    """Chromatic Gibbs over a (chains, graph) device mesh."""

    def __init__(self, cg: CompiledGraph, mesh: jax.sharding.Mesh):
        self.cg = cg
        self.mesh = mesh
        self.n_chains = mesh.shape[CHAINS_AXIS]
        self.n_graph = mesh.shape[GRAPH_AXIS]
        self.kmax = cg.kmax
        self.n_vars = cg.n_vars
        self.n_weights = cg.n_weights
        base = GibbsEngine(cg)
        self.plan_kmax = base.plan_kmax
        self.present = base.present
        # plans with item arrays pre-split per graph shard
        self.plans = [_shard_items(pd, self.n_graph) for pd in base.plans]
        self.var_isev = jnp.asarray(cg.var_isev)
        self.var_init = jnp.asarray(cg.var_init)
        self.weight_fixed = jnp.asarray(cg.weight_fixed)
        self._jit_cache = {}

        s = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
        self._state_sharding = ShardedState(
            var_value=s(CHAINS_AXIS, None),
            var_value_evid=s(CHAINS_AXIS, None),
            weight_value=s(),
            count=s(CHAINS_AXIS, None, None),
        )
        self._plan_spec = [
            {k: P(GRAPH_AXIS) if k.startswith("it_") else P()
             for k in pd} for pd in self.plans]
        # place every item shard on its own device once, here, instead
        # of resharding the plans from the default device on each call
        self.plans = [
            {k: jax.device_put(v, NamedSharding(mesh, spec[k]))
             for k, v in pd.items()}
            for pd, spec in zip(self.plans, self._plan_spec)]
        rep = NamedSharding(mesh, P())
        self.var_isev, self.var_init, self.weight_fixed = jax.device_put(
            (self.var_isev, self.var_init, self.weight_fixed), rep)

    def init_state(self) -> ShardedState:
        C = self.n_chains
        v0 = jnp.tile(jnp.asarray(self.cg.var_init)[None], (C, 1))
        st = ShardedState(
            var_value=v0,
            var_value_evid=v0,
            weight_value=jnp.asarray(self.cg.weight_init),
            count=jnp.zeros((C, self.n_vars, self.kmax), jnp.int32),
        )
        return jax.device_put(st, self._state_sharding)

    # ---- per-shard compute (runs inside shard_map; one chain, one graph
    # shard; collectives stitch the rest) -----------------------------------

    def _partial_potentials(self, pd, kmax, present, var_value,
                            weight_value):
        vals = var_value[pd["it_args_vid"]]
        ks = jnp.arange(kmax, dtype=jnp.int32)
        sub = jnp.where(pd["it_subst"][:, None, :], ks[None, :, None],
                        vals[:, None, :])
        e = eval_factors(pd["it_ftype"][:, None], sub,
                         pd["it_args_eq"][:, None, :],
                         pd["it_args_valid"][:, None, :],
                         pd["it_args_card"][:, None, :],
                         pd["it_arity"][:, None], present)
        w = weight_value[pd["it_wid"]]
        row_card = pd["cv_card"][pd["it_row"]]
        ok = jnp.where(pd["it_dense"][:, None],
                       ks[None, :] < row_card[:, None],
                       (ks[None, :] == pd["it_d1"][:, None]) |
                       (ks[None, :] == pd["it_d2"][:, None]))
        contrib = jnp.where(ok & pd["it_valid"][:, None], w[:, None] * e,
                            0.0)
        R = pd["cv_card"].shape[0]
        return jax.ops.segment_sum(contrib, pd["it_row"], num_segments=R)

    def _color_infer(self, pd, kmax, present, sample_evidence, var_value,
                     weight_value, key):
        pot = self._partial_potentials(pd, kmax, present, var_value,
                                       weight_value)
        pot = jax.lax.psum(pot, GRAPH_AXIS)   # the "halo exchange"
        new = draw(pot, pd["cv_card"], key)
        isev = pd["cv_isev"]
        upd = pd["cv_valid"] & ((isev == _EV_Q) |
                                (sample_evidence & (isev == _EV_E)))
        old = var_value[pd["cv_vid"]]
        out = jnp.where(upd, new, old)
        return var_value.at[pd["cv_scatter"]].set(out, mode="drop")

    def _sweep(self, plans, sample_evidence, var_value, weight_value, key):
        for i, pd in enumerate(plans):
            var_value = self._color_infer(
                pd, self.plan_kmax[i], self.present[i], sample_evidence,
                var_value, weight_value, jax.random.fold_in(key, i))
        return var_value

    def _eval_items_at(self, pd, present, chain, value_it):
        vals = chain[pd["it_args_vid"]]
        sub = jnp.where(pd["it_subst"], value_it[:, None], vals)
        return eval_factors(pd["it_ftype"], sub, pd["it_args_eq"],
                            pd["it_args_valid"], pd["it_args_card"],
                            pd["it_arity"], present)

    def _color_learn(self, pd, kmax, present, lp, var_init, weight_fixed,
                     var_value, var_value_evid, weight_value, step, key):
        key_e, key_p, key_t = jax.random.split(key, 3)
        isev = pd["cv_isev"]
        valid = pd["cv_valid"]

        pot_e = jax.lax.psum(self._partial_potentials(
            pd, kmax, present, var_value_evid, weight_value), GRAPH_AXIS)
        e_samp = draw(pot_e, pd["cv_card"], key_e)
        init_here = var_init[pd["cv_vid"]]
        e_val = jnp.where(isev == _EV_E, init_here, e_samp)

        pot_p = jax.lax.psum(self._partial_potentials(
            pd, kmax, present, var_value, weight_value), GRAPH_AXIS)
        p_val = draw(pot_p, pd["cv_card"], key_p)

        upd = valid & (isev != 4)
        e_val = jnp.where(upd, e_val, var_value_evid[pd["cv_vid"]])
        p_val = jnp.where(upd, p_val, var_value[pd["cv_vid"]])

        e_it = e_val[pd["it_row"]]
        p_it = p_val[pd["it_row"]]
        ev_e = self._eval_items_at(pd, present, var_value_evid, e_it)
        ev_p = self._eval_items_at(pd, present, var_value, p_it)

        slot_hit = (pd["it_d1"] == e_it) | (pd["it_d1"] == p_it) | \
                   (pd["it_d2"] == e_it) | (pd["it_d2"] == p_it)
        include = pd["it_valid"] & (pd["it_dense"] | slot_hit)
        vmask = upd if lp.learn_non_evidence else (valid & (isev == _EV_E))
        include &= vmask[pd["it_row"]]
        include &= ~weight_fixed[pd["it_wid"]]

        grad = jnp.where(include, (ev_p - ev_e) * pd["it_fv"], 0.0)
        gw = jax.ops.segment_sum(grad, pd["it_wid"],
                                 num_segments=self.n_weights)
        nw = jax.ops.segment_sum(include.astype(jnp.float32), pd["it_wid"],
                                 num_segments=self.n_weights)
        # graph axis: sum partial gradients (the reference's master-side
        # "weight_value += sum(dw)" collapses to one psum);
        # chains axis: data-parallel average
        gw = jax.lax.psum(gw, GRAPH_AXIS)
        nw = jax.lax.psum(nw, GRAPH_AXIS)
        gw = jax.lax.pmean(gw, CHAINS_AXIS)
        nw = jax.lax.pmean(nw, CHAINS_AXIS)

        touched = nw > 0
        if lp.grad_agg == "mean":
            gw = gw / jnp.maximum(nw, 1.0)
        w = weight_value
        if lp.regularization == 2:
            shrink = 1.0 / (1.0 + lp.reg_param * step)
            w = jnp.where(touched, w * shrink - step * gw, w)
        elif lp.regularization == 1:
            w = jnp.where(touched, w - step * gw, w)
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

    # ---- shard_map'd epoch loops ------------------------------------------

    def _chain_key(self, key):
        return jax.random.fold_in(key, jax.lax.axis_index(CHAINS_AXIS))

    @staticmethod
    def _local_plans(plans):
        """Drop the leading shard axis of per-device item arrays."""
        return [{k: (v[0] if k.startswith("it_") else v)
                 for k, v in pd.items()} for pd in plans]

    def _infer_shard(self, sample_evidence, plans, var_isev, state, key,
                     burn, epochs):
        plans = self._local_plans(plans)
        # inside shard_map: var_value (1, V); squeeze the chain dim
        vv = state.var_value[0]
        cnt = state.count[0]
        w = state.weight_value
        ck = self._chain_key(key)

        def burn_body(i, vv):
            return self._sweep(plans, sample_evidence, vv, w,
                               jax.random.fold_in(ck, i))

        def epoch_body(i, carry):
            vv, cnt = carry
            vv = self._sweep(plans, sample_evidence, vv, w,
                             jax.random.fold_in(ck, i + (1 << 20)))
            mask = (var_isev == _EV_Q) | \
                (sample_evidence & (var_isev == _EV_E))
            ks = jnp.arange(self.kmax, dtype=jnp.int32)
            onehot = (vv[:, None] == ks[None, :]) & mask[:, None]
            return vv, cnt + onehot.astype(jnp.int32)

        vv = jax.lax.fori_loop(0, burn, burn_body, vv)
        vv, cnt = jax.lax.fori_loop(0, epochs, epoch_body, (vv, cnt))
        return dataclasses.replace(state, var_value=vv[None],
                                   count=cnt[None])

    def _learn_shard(self, lp, plans, var_init, weight_fixed, state, key,
                     burn, epochs, step0, decay):
        plans = self._local_plans(plans)
        vv = state.var_value[0]
        ve = state.var_value_evid[0]
        w = state.weight_value
        ck = self._chain_key(key)

        def burn_body(i, vv):
            return self._sweep(plans, True, vv, w,
                               jax.random.fold_in(ck, i))

        def epoch_body(i, carry):
            vv, ve, w = carry
            ek = jax.random.fold_in(ck, i + (1 << 20))
            step = step0 * jnp.power(decay, i.astype(jnp.float32))
            for ci, pd in enumerate(plans):
                vv, ve, w = self._color_learn(
                    pd, self.plan_kmax[ci], self.present[ci], lp,
                    var_init, weight_fixed, vv, ve, w, step,
                    jax.random.fold_in(ek, ci))
            return vv, ve, w

        vv = jax.lax.fori_loop(0, burn, burn_body, vv)
        vv, ve, w = jax.lax.fori_loop(0, epochs, epoch_body, (vv, ve, w))
        return dataclasses.replace(state, var_value=vv[None],
                                   var_value_evid=ve[None], weight_value=w)

    # ---- public API --------------------------------------------------------

    def _shard_map(self, fn, static):
        from jax import shard_map

        state_spec = ShardedState(
            var_value=P(CHAINS_AXIS, None),
            var_value_evid=P(CHAINS_AXIS, None),
            weight_value=P(),
            count=P(CHAINS_AXIS, None, None),
        )
        in_specs = (self._plan_spec,) + static + \
            (state_spec, P(), P(), P())
        return shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                         out_specs=state_spec)

    def inference(self, state: ShardedState, key, epochs: int,
                  burn: int = 0, sample_evidence: bool = True
                  ) -> ShardedState:
        name = ("infer", sample_evidence)
        if name not in self._jit_cache:
            fn = functools.partial(self._infer_shard, sample_evidence)
            sm = self._shard_map(fn, (P(),))
            self._jit_cache[name] = jax.jit(sm)
        return self._jit_cache[name](
            self.plans, self.var_isev, state, key, jnp.int32(burn),
            jnp.int32(epochs))

    def learn(self, state: ShardedState, key, epochs: int, stepsize: float,
              decay: float = 1.0, burn: int = 0,
              lp: LearnParams = LearnParams()) -> ShardedState:
        name = ("learn", lp)
        if name not in self._jit_cache:
            fn = functools.partial(self._learn_shard, lp)
            state_spec = ShardedState(
                var_value=P(CHAINS_AXIS, None),
                var_value_evid=P(CHAINS_AXIS, None),
                weight_value=P(),
                count=P(CHAINS_AXIS, None, None),
            )
            from jax import shard_map
            sm = shard_map(
                fn, mesh=self.mesh,
                in_specs=(self._plan_spec, P(), P(), state_spec, P(), P(),
                          P(), P(), P()),
                out_specs=state_spec)
            self._jit_cache[name] = jax.jit(sm)
        return self._jit_cache[name](
            self.plans, self.var_init, self.weight_fixed, state, key,
            jnp.int32(burn), jnp.int32(epochs), jnp.float32(stepsize),
            jnp.float32(decay))

    def marginals(self, state: ShardedState, epochs: int) -> np.ndarray:
        """(V, K) marginals pooled over all chains."""
        total = np.asarray(state.count, np.float64).sum(axis=0)
        return total / float(max(epochs, 1) * self.n_chains)
