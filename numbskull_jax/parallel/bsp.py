"""Bulk-synchronous partitioned Gibbs — the reference's distributed mode.

Reference analog: the salt master/minion epoch loop
(salt/src/numbskull_master.py:133-233, salt/src/numbskull_minion.py:225-280):
each part samples its owned variables against one-sync-stale boundary
values, parts exchange after every local epoch, and learning sums per-part
weight deltas at the coordinator (numbskull_master.py:223-224).

Two boundary treatments:

- ``mode="values"``: a straddling factor is replicated on every part that
  owns one of its variables; ghost (non-owned) variable values refresh at
  each sync. This is the reference's default exchange
  (salt/src/messages.py:1253-1319 compute_map_* / compute_vars_to_send).

- ``mode="messages"``: every factor lives ONLY on its owner part; a part
  whose variable appears in a remote factor receives a per-value potential
  message instead: m(v, k) = sum over remote factors f touching v of
  w_f * eval_f(v=k, sender's current values). This generalizes BOTH of
  the reference's boundary compressions — UFO per-value potential deltas
  (salt/src/messages.py:942-1066 compute_ufo_values) and PF scalar partial
  evaluations (messages.py:1332-1355 compute_pf_values) — to every factor
  type, and it is algebraically exact for the receiver's conditional:
  traffic per straddling factor drops from O(arity) variable values to
  O(cardinality) floats per touched remote variable, aggregated per
  variable (the same wire format as one UFO factor).

Each part runs on its own device; exchanges hop through the coordinator
device between syncs while each part's sweep stays one on-device
program. This module expresses the loop in one process (the reference's
``machines=0`` master-only baseline is the same degenerate case,
numbskull_master.py:190-192); `parallel.multihost` provides process
placement. The EXACT-synchronous alternative with zero staleness at any
device count is `parallel.sharded.ShardedGibbsEngine` — use that over
fast links such as NVLink; use BSP semantics when syncing over slow links
where one collective per color step would dominate.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from numbskull_jax.compile import (
    _pad_to, build_attachments, compile_graph, fold_attachments,
    pack_item_block,
)
from numbskull_jax.ops.factor_eval import present_types_of
from numbskull_jax.ops.gibbs import (
    GibbsEngine, LearnParams, SamplerState, color_potentials,
)


def factor_owner(factors, fmap, part: np.ndarray) -> np.ndarray:
    """(F,) owner part of each factor = part of its first variable
    (deterministic stand-in for the reference's partition-key schemes,
    salt/src/numbskull_master.py:329-334)."""
    first_vid = fmap["vid"][factors["ftv_offset"].astype(np.int64)]
    return part[first_vid.astype(np.int64)]


@dataclasses.dataclass
class MessagePlan:
    """Device plan computing one part's outgoing boundary messages."""

    pd: dict                 # color_potentials-compatible plan arrays
    present: tuple           # factor types present (static)
    scatter_vid: jax.Array   # (R,) target vid per row; pad rows -> V (drop)
    n_targets: int


def _build_message_plan(variables, factors, fmap, owned_fids: np.ndarray,
                        target_mask: np.ndarray, n_vars: int,
                        item_pad: int = 128,
                        row_pad: int = 8) -> MessagePlan | None:
    """Plan for m(v, k) over all non-owned variables v touched by this
    part's owned factors (rows = target variables, items = (factor, v)
    incidences; reuses the compiler's attachment/fold/pack pipeline)."""
    F = len(factors)
    skip = np.setdiff1d(np.arange(F, dtype=np.int64), owned_fids,
                        assume_unique=False)
    att_f, att_v, att_d = build_attachments(variables, factors, fmap,
                                            factors_to_skip=skip)
    sel = target_mask[att_v]
    att_f, att_v, att_d = att_f[sel], att_v[sel], att_d[sel]
    if not len(att_f):
        return None
    item_f, item_v, item_d1, item_d2 = fold_attachments(att_f, att_v, att_d)

    tvids = np.unique(item_v)
    R = _pad_to(len(tvids), row_pad) + 1
    row_of = np.zeros(n_vars, np.int64)
    row_of[tvids] = np.arange(len(tvids))

    order = np.argsort(row_of[item_v], kind="stable")
    it, _ = pack_item_block(variables, factors, fmap,
                            item_f[order], item_v[order],
                            item_d1[order], item_d2[order],
                            row_of[item_v[order]], R, item_pad=item_pad)

    cv_vid = np.zeros(R, np.int32)
    cv_card = np.ones(R, np.int32)
    cv_vid[:len(tvids)] = tvids
    cv_card[:len(tvids)] = variables["cardinality"][tvids]
    scatter = np.full(R, n_vars, np.int64)       # pad rows dropped
    scatter[:len(tvids)] = tvids

    pd = {k: jnp.asarray(v) for k, v in it.items()}
    pd["cv_vid"] = jnp.asarray(cv_vid)
    pd["cv_card"] = jnp.asarray(cv_card)
    return MessagePlan(pd=pd,
                       present=present_types_of(it["it_ftype"]),
                       scatter_vid=jnp.asarray(scatter.astype(np.int32)),
                       n_targets=len(tvids))


class BSPEngine:
    """Partitioned Gibbs with per-sync boundary exchange (stale halos).

    Parameters mirror ``NumbSkull.loadFactorGraph`` plus a variable
    partition. Each part compiles its own chromatic schedule over its
    local factor set; non-owned variables are frozen (isEvidence=4,
    reference numbskull/inference.py:21-23) and refreshed at syncs.
    """

    def __init__(self, weights, variables, factors, fmap,
                 part: np.ndarray, mode: str = "values",
                 domain_mask=None, max_colors=None, seed: int = 0,
                 devices=None):
        """``devices``: optional list — part p's graph data and sampler
        run on devices[p % len(devices)]; exchanges and weight-delta
        summation hop through devices[0] (the coordinator), modeling the
        reference's master role. Default: all parts on the default
        device (the reference's machines=0 baseline)."""
        assert mode in ("values", "messages")
        self.mode = mode
        self.devices = list(devices) if devices else None
        part = np.asarray(part, np.int64)
        self.part = part
        self.n_parts = int(part.max()) + 1 if len(part) else 1
        self.n_vars = len(variables)
        self.seed = seed

        owner = factor_owner(factors, fmap, part)
        self.factor_owner = owner
        F = len(factors)
        arity = factors["arity"].astype(np.int64)
        offs = factors["ftv_offset"].astype(np.int64)
        fvid = fmap["vid"].astype(np.int64)
        edge_fid = np.repeat(np.arange(F, dtype=np.int64), arity)
        edge_part = part[fvid]

        self.engines: list[GibbsEngine] = []
        self.msg_plans: list[MessagePlan | None] = []
        self.owned_masks: list[np.ndarray] = []
        for p in range(self.n_parts):
            owned_vars = part == p
            self.owned_masks.append(owned_vars)
            if mode == "values":
                # keep factors touching >=1 owned var
                touches = np.zeros(F, bool)
                np.logical_or.at(touches, edge_fid, edge_part == p)
                skip = np.flatnonzero(~touches).astype(np.int64)
            else:
                skip = np.flatnonzero(owner != p).astype(np.int64)
            v = variables.copy()
            v["isEvidence"] = np.where(owned_vars, variables["isEvidence"],
                                       np.int8(4))
            cg = compile_graph(weights, v, factors, fmap,
                               factors_to_skip=skip,
                               max_colors=max_colors,
                               domain_mask=domain_mask, seed=seed)
            eng = GibbsEngine(cg)
            if self.devices:
                self._move_engine(eng, self._dev(p))
            self.engines.append(eng)
            if mode == "messages":
                owned_fids = np.flatnonzero(owner == p).astype(np.int64)
                mp = _build_message_plan(
                    variables, factors, fmap, owned_fids,
                    target_mask=~owned_vars, n_vars=self.n_vars)
                if mp is not None and self.devices:
                    mp.pd = {k: jax.device_put(a, self._dev(p))
                             for k, a in mp.pd.items()}
                self.msg_plans.append(mp)
            else:
                self.msg_plans.append(None)

        self.kmax = self.engines[0].kmax
        # ownership masks live at the coordinator (combine site)
        self._owned_dev = [
            jax.device_put(jnp.asarray(m), self._dev(0)) if self.devices
            else jnp.asarray(m) for m in self.owned_masks]

        # boundary variables: appear in a factor that straddles parts
        fac_min = np.full(F, self.n_parts, np.int64)
        fac_max = np.full(F, -1, np.int64)
        np.minimum.at(fac_min, edge_fid, edge_part)
        np.maximum.at(fac_max, edge_fid, edge_part)
        straddles = fac_min != fac_max
        bvar = np.zeros(self.n_vars, bool)
        bvar[fvid[straddles[edge_fid]]] = True
        self.boundary_vars = bvar

    def _dev(self, p: int):
        return self.devices[p % len(self.devices)]

    def _put(self, x, p: int):
        return jax.device_put(x, self._dev(p)) if self.devices else x

    @staticmethod
    def _move_engine(eng: GibbsEngine, device) -> None:
        """Pin an engine's compiled plan arrays to one device so its
        jitted sweeps execute there."""
        def mv(x):
            return jax.device_put(x, device) if isinstance(x, jax.Array) \
                else x
        if eng.scan_colors:
            eng.stacked = {k: mv(v) for k, v in eng.stacked.items()}
        if eng.padded is not None:
            eng.padded = {k: mv(v) for k, v in eng.padded.items()}
        eng.plans = [{k: mv(v) for k, v in pd.items()}
                     for pd in eng.plans]
        eng.var_card = mv(eng.var_card)
        eng.var_isev = mv(eng.var_isev)
        eng.var_init = mv(eng.var_init)
        eng.weight_fixed = mv(eng.weight_fixed)

    # --- state -------------------------------------------------------------

    def init_states(self) -> list[SamplerState]:
        return [jax.tree_util.tree_map(lambda x: self._put(x, p),
                                       eng.init_state())
                for p, eng in enumerate(self.engines)]

    # --- sync primitives (the boundary exchange, reference §3.4) ------------

    def _global_values(self, states, attr: str):
        """Combine per-part chains: every variable's value from its owner
        (multi-device: each part's slice hops to the coordinator)."""
        out = self._put(getattr(states[0], attr), 0)
        for p in range(1, self.n_parts):
            out = jnp.where(self._owned_dev[p],
                            self._put(getattr(states[p], attr), 0), out)
        # part 0's non-owned slice is overwritten by owners above; vars
        # owned by part 0 come from states[0] because no later part owns
        # them -> exact ownership semantics
        return out

    def exchange(self, states) -> list[SamplerState]:
        """Refresh every part's ghost values from the owners (the
        reference's per-epoch boundary variable shipping; multi-device:
        gather at the coordinator, scatter to each part's device)."""
        gv = self._global_values(states, "var_value")
        ge = self._global_values(states, "var_value_evid")
        return [dataclasses.replace(s, var_value=self._put(gv, p),
                                    var_value_evid=self._put(ge, p))
                for p, s in enumerate(states)]

    def messages(self, states, chain: str = "var_value"):
        """(V, K) summed incoming boundary potential messages (UFO/PF
        generalization), reduced at the coordinator; None in values
        mode."""
        if self.mode != "messages":
            return None
        ext = self._put(jnp.zeros((self.n_vars, self.kmax), jnp.float32),
                        0)
        for p, mp in enumerate(self.msg_plans):
            if mp is None:
                continue
            m = color_potentials(mp.pd, self.kmax, mp.present,
                                 getattr(states[p], chain),
                                 states[p].weight_value)
            ext = ext.at[self._put(mp.scatter_vid, 0)].add(
                self._put(m, 0), mode="drop")
        return ext

    # --- epoch loops ---------------------------------------------------------

    def inference(self, states, key, epochs: int, burn: int = 0,
                  sample_evidence: bool = True, sync_every: int = 1):
        """Burn-in then tallying epochs; ghosts/messages refresh every
        ``sync_every`` local epochs (reference syncs every epoch)."""
        step_id = 0
        for phase, n in (("burn", burn), ("epoch", epochs)):
            done = 0
            while done < n:
                k = min(sync_every, n - done)
                ext = self.messages(states)
                kk = jax.random.fold_in(key, step_id)
                states = [
                    eng.inference(
                        st, jax.random.fold_in(kk, p),
                        epochs=0 if phase == "burn" else k,
                        burn=k if phase == "burn" else 0,
                        sample_evidence=sample_evidence,
                        ext_pot=None if ext is None else self._put(ext, p))
                    for p, (eng, st) in enumerate(zip(self.engines, states))
                ]
                states = self.exchange(states)
                done += k
                step_id += 1
        return states

    def learn(self, states, key, epochs: int, stepsize: float,
              decay: float = 1.0, burn: int = 0,
              lp: LearnParams = LearnParams()):
        """Distributed SGD: per-sync local epoch, weight deltas summed
        across parts (the reference's parameter-server reduction,
        numbskull_master.py:223-224), weights re-broadcast."""
        if burn:
            states = self.inference(states,
                                    jax.random.fold_in(key, 1 << 30),
                                    epochs=0, burn=burn,
                                    sample_evidence=True)
        w_global = self._put(states[0].weight_value, 0)
        states = [dataclasses.replace(s, weight_value=self._put(w_global,
                                                                p))
                  for p, s in enumerate(states)]
        for e in range(epochs):
            ext = self.messages(states)
            ext_e = self.messages(states, "var_value_evid")
            step = stepsize * (decay ** e)
            kk = jax.random.fold_in(key, e)
            new_states = []
            dw_sum = jnp.zeros_like(w_global)
            for p, (eng, st) in enumerate(zip(self.engines, states)):
                st2 = eng.learn(
                    st, jax.random.fold_in(kk, p), epochs=1,
                    stepsize=step, decay=1.0, burn=0, lp=lp,
                    ext_pot=None if ext is None else self._put(ext, p),
                    ext_pot_evid=(None if ext_e is None
                                  else self._put(ext_e, p)))
                dw_sum = dw_sum + (self._put(st2.weight_value, 0) -
                                   w_global)
                new_states.append(st2)
            w_global = w_global + dw_sum
            states = [dataclasses.replace(
                s, weight_value=self._put(w_global, p))
                for p, s in enumerate(new_states)]
            states = self.exchange(states)
        return states

    # --- results -------------------------------------------------------------

    def marginals(self, states, epochs: int) -> np.ndarray:
        """(V, K) marginals: each variable's tally from its owner part."""
        cnt = self._put(states[0].count, 0)
        for p in range(1, self.n_parts):
            cnt = jnp.where(self._owned_dev[p][:, None],
                            self._put(states[p].count, 0), cnt)
        return np.asarray(cnt) / float(max(epochs, 1))

    def weights(self, states) -> np.ndarray:
        return np.asarray(states[0].weight_value)

    # --- traffic accounting (the PF/UFO bandwidth claim, quantified) ---------

    def sync_traffic(self) -> dict:
        """Per-sync payload sizes in scalar counts: boundary variable
        values (values mode ships each once) vs message floats (messages
        mode ships kmax floats per (sender part, target var) pair) —
        quantifies the compression the reference's PF/UFO tricks buy."""
        msg_floats = sum(mp.n_targets * self.kmax
                         for mp in self.msg_plans if mp is not None)
        return {"mode": self.mode,
                "boundary_values_per_sync": int(self.boundary_vars.sum()),
                "message_floats_per_sync": msg_floats}
