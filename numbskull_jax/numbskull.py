"""Public API + CLI: the `NumbSkull` class and `numbskull-jax` entrypoint.

Mirrors the reference's declarative argument/flag surface and output-file
contract (reference: numbskull/numbskull.py:18-149 argument tables,
:359-391 inference/learning output files, :394-423 load/main) so DeepDive
pipelines and reference users can switch without changes — but everything
under the hood is the XLA engine (`numbskull_jax.ops.GibbsEngine`).
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import numpy as np

from numbskull_jax import dataloading
from numbskull_jax import types as T
from numbskull_jax.compile import compile_graph
from numbskull_jax.observability import metrics
from numbskull_jax.ops import GibbsEngine, LearnParams
from numbskull_jax.timer import Timer

# Declarative argument tables shared by the CLI and the class, mirroring
# reference numbskull/numbskull.py:18-126 (same dests and defaults).
arguments = [
    (("directory",),
        {"metavar": "DIRECTORY", "nargs": "?", "default": ".", "type": str,
         "help": "specify the directory of factor graph files"}),
    (("-o", "--output_dir"),
        {"metavar": "OUTPUT_DIR", "dest": "output_dir", "default": ".",
         "type": str,
         "help": "output dir for inference_result.out.text and "
                 "inference_result.out.weights.text"}),
    (("-m", "--meta", "--fg_meta"),
        {"metavar": "META_FILE", "dest": "metafile", "default": "graph.meta",
         "type": str, "help": "factor graph metadata file"}),
    (("-w", "--weight", "--weights"),
        {"metavar": "WEIGHTS_FILE", "dest": "weightfile",
         "default": "graph.weights", "type": str,
         "help": "factor weight file"}),
    (("-v", "--variable", "--variables"),
        {"metavar": "VARIABLES_FILE", "dest": "variablefile",
         "default": "graph.variables", "type": str,
         "help": "factor graph variables file"}),
    (("-f", "--factor", "--factors"),
        {"metavar": "FACTORS_FILE", "dest": "factorfile",
         "default": "graph.factors", "type": str, "help": "factor file"}),
    (("--domain", "--domains"),
        {"metavar": "DOMAINS_FILE", "dest": "domainfile",
         "default": "graph.domains", "type": str, "help": "domain file"}),
    (("-l", "--n_learning_epoch"),
        {"metavar": "NUM_LEARNING_EPOCHS", "dest": "n_learning_epoch",
         "default": 0, "type": int, "help": "number of learning epochs"}),
    (("-i", "--n_inference_epoch"),
        {"metavar": "NUM_INFERENCE_EPOCHS", "dest": "n_inference_epoch",
         "default": 0, "type": int, "help": "number of inference epochs"}),
    (("-s", "--stepsize", "-a", "--alpha"),
        {"metavar": "LEARNING_STEPSIZE", "dest": "stepsize",
         "default": 0.01, "type": float, "help": "stepsize for learning"}),
    (("-d", "--decay", "--diminish"),
        {"metavar": "LEARNING_DECAY", "dest": "decay", "default": 0.95,
         "type": float, "help": "stepsize decay per learning epoch"}),
    (("-r", "--reg_param"),
        {"metavar": "LEARNING_REGULARIZATION_PARAM", "dest": "reg_param",
         "default": 0.01, "type": float, "help": "regularization penalty"}),
    (("--regularization",),
        {"metavar": "REGULARIZATION", "dest": "regularization", "default": 2,
         "type": int, "help": "regularization (1 = L1, 2 = L2)"}),
    (("-k", "--truncation"),
        {"metavar": "TRUNCATION", "dest": "truncation", "default": 1,
         "type": int,
         "help": "L1 truncated-gradient: truncate with probability 1/k and "
                 "magnitude step_size * reg_param * k"}),
    (("-b", "--burn_in"),
        {"metavar": "BURN_IN", "dest": "burn_in", "default": 0, "type": int,
         "help": "number of burn-in epochs"}),
    (("-t", "--threads", "--n_threads"),
        {"metavar": "NUM_THREADS", "dest": "nthreads", "default": 1,
         "type": int,
         "help": "accepted for reference compatibility; the engine "
                 "parallelizes per color block, not per thread"}),
    (("-u", "--dburl"),
        {"metavar": "DATABASE_URL", "dest": "dburl", "default": "",
         "type": str, "help": "database URL (distributed graph source)"}),
    (("--seed",),
        {"metavar": "SEED", "dest": "seed", "default": 0, "type": int,
         "help": "PRNG seed (counter-based jax.random; fully reproducible)"}),
    (("--grad_agg",),
        {"metavar": "GRAD_AGG", "dest": "grad_agg", "default": "mean",
         "type": str, "choices": ("mean", "sum"),
         "help": "per-color gradient aggregation: 'mean' (stable "
                 "mini-batch SGD, default) or 'sum' (reproduces the "
                 "reference's aggregate per-epoch weight movement, "
                 "learning.py:111-125)"}),
    (("--checkpoint",),
        {"metavar": "CHECKPOINT_FILE", "dest": "checkpoint", "default": "",
         "type": str,
         "help": "checkpoint inference to FILE (and learning to "
                 "FILE.learn: weights, both chains, stepsize schedule) "
                 "every --checkpoint_every epochs and resume from it if "
                 "it exists. Chunks draw the same random stream as an "
                 "uninterrupted run, so a resumed run equals an "
                 "uninterrupted one bit for bit (on the CPU, and "
                 "measured on an H100 GPU, resumed in the same "
                 "process or a new one)"}),
    (("--checkpoint_every",),
        {"metavar": "N", "dest": "checkpoint_every", "default": 100,
         "type": int, "help": "epochs between checkpoints"}),
    (("--metrics_out",),
        {"metavar": "METRICS_JSON", "dest": "metrics_out", "default": "",
         "type": str,
         "help": "write a JSON metrics snapshot (epochs, wall times, "
                 "update counts) after the run"}),
    (("--plan_cache",),
        {"metavar": "DIR", "dest": "plan_cache", "default": "",
         "type": str,
         "help": "disk plan cache directory (default: NSX_PLAN_CACHE "
                 "env var): byte-identical graphs reload their compiled "
                 "color plans instead of recompiling (see plancache)"}),
    (("--max_colors",),
        {"metavar": "MAX_COLORS", "dest": "max_colors", "default": None,
         "type": int,
         "help": "cap chromatic colors; overflow vars share the last color "
                 "(hogwild-style races, like the reference's threads)"}),
    (("--parts",),
        {"metavar": "N", "dest": "parts", "default": 0, "type": int,
         "help": "run the whole job PARTITIONED into N parts: choose a "
                 "partition (DB partition keys compete against the "
                 "cost-model menu), distributed learning with per-epoch "
                 "weight-delta reduction, distributed inference, same "
                 "output files — the reference's one-command cluster "
                 "flow (salt/src/numbskull_master.py:547-584)"}),
    (("--dist_mode",),
        {"metavar": "MODE", "dest": "dist_mode", "default": "auto",
         "type": str, "choices": ("auto", "values", "messages"),
         "help": "boundary exchange for --parts: ghost values or "
                 "per-value potential messages (the PF/UFO "
                 "generalization); auto picks messages when every "
                 "straddling factor is UFO-eligible"}),
]

flags = [
    (("--sample_evidence",),
        {"default": True, "dest": "sample_evidence", "action": "store_true",
         "help": "sample evidence variables during inference"}),
    (("--learn_non_evidence",),
        {"default": False, "dest": "learn_non_evidence",
         "action": "store_true",
         "help": "compute gradients from non-evidence variables"}),
    (("-q", "--quiet"),
        {"default": False, "dest": "quiet", "action": "store_true",
         "help": "quiet"}),
    (("--verbose",),
        {"default": False, "dest": "verbose", "action": "store_true",
         "help": "verbose"}),
]


def _native_dump(path: str, a, b, x, dec: int) -> bool:
    """Write `a [b] x` text rows via the native core (compilecore.so
    dump_rows); returns False when unavailable (numpy fallback runs)."""
    from numbskull_jax.compile import _compilecore, _ptr
    core = _compilecore()
    if core is None:
        return False
    import ctypes
    a = np.ascontiguousarray(a, np.int64)
    bp = None
    if b is not None:
        b = np.ascontiguousarray(b, np.int64)
        bp = _ptr(b)
    x = np.ascontiguousarray(x, np.float64)
    rc = core.dump_rows(path.encode(), ctypes.c_int64(len(a)), _ptr(a),
                        bp, _ptr(x), ctypes.c_int(dec))
    return rc == 0


def _digit_block(a: np.ndarray, width: int, pad_zero: bool,
                 neg: np.ndarray | None) -> np.ndarray:
    """(N, width) uint8 right-aligned decimal digits of non-negative
    ``a``; leading positions are spaces (or zeros when ``pad_zero``),
    with '-' placed just left of the first digit for ``neg`` rows.

    Pure digit arithmetic — every numpy text conversion (astype('S'),
    np.char, savetxt) is a per-element sprintf and takes minutes at
    9.4M rows; this is a handful of vectorized integer passes."""
    n = len(a)
    out = np.empty((n, width), np.uint8)
    dt = np.int32 if (n == 0 or int(a.max()) < 2 ** 31) else np.int64
    cur = np.asarray(a).astype(dt, copy=True)
    live = np.ones(n, bool)            # rows with digits remaining
    prev = live
    for k in range(width):             # k-th digit from the right
        col = width - 1 - k
        digit = (cur % 10 + 48).astype(np.uint8)
        if pad_zero or k == 0:
            out[:, col] = digit
        else:
            # '-' lands one column left of a row's last digit
            fill = np.uint8(32) if neg is None else \
                np.where(prev & ~live & neg, np.uint8(45), np.uint8(32))
            out[:, col] = np.where(live, digit, fill)
        np.floor_divide(cur, 10, out=cur)
        prev = live
        live = live & (cur > 0)
    return out


def _int_width(a: np.ndarray) -> int:
    m = int(a.max()) if len(a) else 0
    return max(len(str(max(m, 1))), 1)


def _format_cols(cols) -> bytes:
    """`vid value prob`-style rows as one bytes blob: space-separated,
    right-aligned columns, newline-terminated. Each col is an int array
    or a ('fixed', array, decimals) fixed-point spec."""
    blocks = []
    n = None
    for c in cols:
        if isinstance(c, tuple):
            _, x, dec = c
            scale = 10 ** dec
            pm = np.round(np.asarray(x, np.float64) * scale).astype(
                np.int64)
            neg = pm < 0
            ap = np.abs(pm)
            ip, fr = ap // scale, ap % scale
            w = _int_width(ip) + (1 if neg.any() else 0)
            blocks.append(_digit_block(ip, w, False, neg))
            blocks.append(np.full((len(ip), 1), 46, np.uint8))   # '.'
            blocks.append(_digit_block(fr, dec, True, None))
        else:
            x = np.asarray(c, np.int64)
            neg = x < 0
            w = _int_width(np.abs(x)) + (1 if neg.any() else 0)
            blocks.append(_digit_block(np.abs(x), w, False, neg))
        n = len(x)
        blocks.append(np.full((n, 1), 32, np.uint8))             # ' '
    if n is None or n == 0:
        return b""
    blocks[-1][:] = 10                                           # '\n'
    return np.hstack(blocks).tobytes()


class FactorGraph:
    """One loaded factor graph: compiled plans + device engine + state.

    Role-equivalent of the reference FactorGraph
    (numbskull/factorgraph.py:27-229), with sampler state living on
    device and marginal tallies kept per (variable, value).
    """

    def __init__(self, cg, fid: int, seed: int = 0):
        self.cg = cg
        self.fid = fid
        self.engine = GibbsEngine(cg)
        self.state = self.engine.init_state()
        self.key = jax.random.PRNGKey(seed)
        self.inference_epochs_done = 0
        self.inference_total_time = 0.0
        self.learning_total_time = 0.0

    def _next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def burnIn(self, epochs: int, sample_evidence: bool):
        self.state = self.engine.inference(
            self.state, self._next_key(), epochs=0, burn=epochs,
            sample_evidence=sample_evidence)

    def inference(self, burnin_epochs: int, epochs: int,
                  sample_evidence: bool = False, diagnostics: bool = False,
                  checkpoint: str = "", checkpoint_every: int = 100):
        if checkpoint:
            # chunked + checkpointed: a single BASE key is drawn up
            # front and every chunk passes its absolute epoch offset, so
            # the chunked run draws the same random stream as an
            # uninterrupted one.
            from numbskull_jax.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
            checkpoint_every = max(int(checkpoint_every), 1)
            done = 0
            base_key = None
            if os.path.exists(checkpoint):
                self.state, base_key, meta = load_checkpoint(checkpoint)
                done = int(meta.get("epochs_done", 0))
                metrics.add("inference.resumes")
            if base_key is None:
                base_key = self._next_key()
            while done < epochs:
                n = min(checkpoint_every, epochs - done)
                self._infer_once(burnin_epochs if done == 0 else 0, n,
                                 sample_evidence, base_key,
                                 epoch_offset=done)
                done += n
                save_checkpoint(checkpoint, self.state, base_key,
                                meta={"epochs_done": done})
            if diagnostics:
                self.diagnostics(self.inference_epochs_done)
            return
        self._infer_once(burnin_epochs, epochs, sample_evidence,
                         self._next_key(), epoch_offset=0)
        if diagnostics:
            print("FACTOR %d: inference %d epochs took %.3f sec" %
                  (self.fid, epochs, self._last_infer_s))
            self.diagnostics(self.inference_epochs_done)

    def _infer_once(self, burnin_epochs: int, epochs: int,
                    sample_evidence: bool, key, epoch_offset: int):
        """One inference run with an explicit key."""
        with Timer() as t:
            self.state = self.engine.inference(
                self.state, key, epochs=epochs,
                burn=burnin_epochs, sample_evidence=sample_evidence,
                epoch_offset=epoch_offset)
            jax.block_until_ready(self.state.count)
        metrics.observe("inference.run_s", t.interval)
        metrics.add("inference.epochs", epochs + burnin_epochs)
        metrics.add("inference.variable_updates",
                    float(self.cg.n_vars) * (epochs + burnin_epochs))
        self.inference_total_time += t.interval
        self.inference_epochs_done += epochs
        self._last_infer_s = t.interval

    def learn(self, burnin_epochs: int, epochs: int, stepsize: float,
              decay: float, regularization: int, reg_param: float,
              truncation: int, diagnostics: bool = False,
              verbose: bool = False, learn_non_evidence: bool = False,
              grad_agg: str = "mean", checkpoint: str = "",
              checkpoint_every: int = 100):
        lp = LearnParams(regularization=regularization, reg_param=reg_param,
                         truncation=truncation,
                         learn_non_evidence=learn_non_evidence,
                         grad_agg=grad_agg)
        if checkpoint:
            # chunked + checkpointed learning (weights, BOTH chains,
            # stepsize epoch index); the reference's primary distributed
            # workload was long learning runs with no mid-run
            # persistence at all (factorgraph.py:190-204). Guarantee as
            # for inference: interrupted == uninterrupted CHUNKED run.
            from numbskull_jax.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
            checkpoint_every = max(int(checkpoint_every), 1)
            done = 0
            base_key = None
            # a fully-resumed run skips every _learn_once (which is what
            # sets the timing) - seed it for the diagnostics print
            self._last_learn_s = 0.0
            if os.path.exists(checkpoint):
                self.state, base_key, meta = load_checkpoint(checkpoint)
                done = int(meta.get("learn_epochs_done", 0))
                metrics.add("learning.resumes")
            if base_key is None:
                base_key = self._next_key()
            while done < epochs:
                n = min(checkpoint_every, epochs - done)
                self._learn_once(burnin_epochs if done == 0 else 0, n,
                                 stepsize * decay ** done, decay, lp,
                                 base_key, epoch_offset=done)
                done += n
                save_checkpoint(checkpoint, self.state, base_key,
                                meta={"learn_epochs_done": done})
        else:
            self._learn_once(burnin_epochs, epochs, stepsize, decay, lp,
                             self._next_key(), epoch_offset=0)
        if diagnostics:
            print("FACTOR %d: learning %d epochs took %.3f sec" %
                  (self.fid, epochs, self._last_learn_s))
            if verbose:
                self.diagnosticsLearning()

    def _learn_once(self, burnin_epochs: int, epochs: int,
                    stepsize: float, decay: float, lp, key,
                    epoch_offset: int):
        """One learning run with an explicit key; continues both chains
        from the current state so chunked runs compose."""
        with Timer() as t:
            self.state = self.engine.learn(
                self.state, jax.random.fold_in(key, epoch_offset),
                epochs=epochs, stepsize=stepsize, decay=decay,
                burn=burnin_epochs, lp=lp)
            jax.block_until_ready(self.state.weight_value)
        metrics.observe("learning.run_s", t.interval)
        metrics.add("learning.epochs", epochs)
        self.learning_total_time += t.interval
        self._last_learn_s = t.interval

    # --- getters / diagnostics (reference factorgraph.py:84-123) ----------

    def getWeights(self) -> np.ndarray:
        return np.asarray(self.state.weight_value)

    def getMarginals(self, epochs: int | None = None) -> np.ndarray:
        """Marginals in the reference's cardinality-compressed layout."""
        epochs = epochs or self.inference_epochs_done or 1
        counts = np.asarray(self.state.count, np.float64) / epochs
        return self._compress(counts)

    def full_marginals(self, epochs: int | None = None) -> np.ndarray:
        """(V, K) marginal matrix."""
        epochs = epochs or self.inference_epochs_done or 1
        return np.asarray(self.state.count, np.float64) / epochs

    def _out_layout(self):
        """Flat cstart output layout (binary vars: one slot, at k=1).

        Returns (vrep, kidx): the (variable, value-index) of every output
        slot, vectorized (no per-variable Python at multi-M-var scale)."""
        return _out_layout_for(np.asarray(self.cg.var_card, np.int64))

    def _compress(self, counts_vk: np.ndarray) -> np.ndarray:
        """(V, K) -> flat cstart layout (binary vars: P(v=1) only)."""
        vrep, kidx = self._out_layout()
        return counts_vk[vrep, kidx]

    def diagnostics(self, epochs: int):
        print("Inference took %.03f sec." % self.inference_total_time)
        epochs = epochs or 1
        marg = self._compress(np.asarray(self.state.count, np.float64))
        hist, _ = np.histogram(marg / epochs, bins=10, range=(0.0, 1.0))
        for i in range(10):
            print("Prob. %.1f..%.1f: %d variables" %
                  (i / 10.0, (i + 1) / 10.0, hist[i]))

    def diagnosticsLearning(self):
        print("Weights:")
        w = self.getWeights()
        for i in range(self.cg.n_weights):
            print("    weightId:", i)
            print("        isFixed:", bool(self.cg.weight_fixed[i]))
            print("        weight: ", float(w[i]))

    # --- dumps (DimmWitted text format, reference factorgraph.py:210-229) --

    def dump_weights(self, fout: str):
        dump_weight_text(self.getWeights()[:self.cg.n_weights], fout)

    def dump_probabilities(self, fout: str, epochs: int):
        """DimmWitted `vid value prob` text dump, array-formatted (a
        9.4M-var graph dumps in seconds, not minutes of Python loop)."""
        dump_marginal_text(self.cg, np.asarray(self.state.count,
                                               np.float64), epochs, fout)


def _out_layout_for(card: np.ndarray):
    """Flat cstart output layout over a cardinality vector (binary
    vars: one slot, at k=1); see FactorGraph._out_layout."""
    if not len(card):
        z = np.zeros(0, np.int64)
        return z, z
    nsl = np.where(card == 2, 1, card)
    csum = np.cumsum(nsl)
    vrep = np.repeat(np.arange(len(card)), nsl)
    within = np.arange(csum[-1]) - np.repeat(csum - nsl, nsl)
    kidx = within + (card[vrep] == 2)
    return vrep, kidx


def dump_marginal_text(cg, counts: np.ndarray, epochs: int, fout: str):
    """DimmWitted `vid value prob` dump from a (V, K) count matrix
    (shared by FactorGraph and the distributed runner)."""
    epochs = epochs or 1
    card = np.asarray(cg.var_card, np.int64)
    vrep, kidx = _out_layout_for(card)
    prob = counts[vrep, kidx] / epochs
    dt = np.asarray(cg.var_dtype, np.int64)
    vo = np.asarray(cg.vtf_offset, np.int64)
    vmapv = np.asarray(cg.vmap_value, np.int64)
    binary = card[vrep] == 2
    # dense multi-valued variables: values ARE 0..card-1 (the
    # reference's dump reads past its single vmap slot here,
    # factorgraph.py:226-228 — a latent bug its tests never hit; we
    # write the identity values). Categorical: the original domain
    # value at this slot.
    dense_val = kidx
    if len(vmapv):
        dom_idx = np.minimum(vo[vrep] + kidx, len(vmapv) - 1)
        cat_val = vmapv[dom_idx]
    else:
        cat_val = kidx
    value = np.where(binary, 1,
                     np.where(dt[vrep] == 0, dense_val, cat_val))
    if _native_dump(fout, vrep, value, prob, 3):
        return
    with open(fout, "wb") as out:
        out.write(_format_cols((vrep, value, ("fixed", prob, 3))))


def dump_weight_text(weights: np.ndarray, fout: str):
    """DimmWitted `wid weight` dump."""
    w = np.asarray(weights, np.float64)
    ids = np.arange(len(w))
    if _native_dump(fout, ids, None, w, 6):
        return
    with open(fout, "wb") as out:
        out.write(_format_cols((ids, ("fixed", w, 6))))


class NumbSkull:
    """Main user-facing class; drop-in analog of the reference NumbSkull
    (numbskull/numbskull.py:152-391)."""

    def __init__(self, **kwargs):
        arg_defaults = {}
        for arg, opts in arguments:
            if arg[0] == "directory":
                arg_defaults["directory"] = opts["default"]
            else:
                arg_defaults[opts["dest"]] = opts["default"]
        for arg, opts in flags:
            arg_defaults[opts["dest"]] = opts["default"]
        for key, default in arg_defaults.items():
            setattr(self, key, kwargs.get(key, default))
        self.factorGraphs: list[FactorGraph] = []

    # --- loading -----------------------------------------------------------

    def loadFactorGraph(self, weight, variable, factor, fmap, domain_mask,
                        edges, var_copies=1, weight_copies=1,
                        factors_to_skip=np.empty(0, np.int64)):
        """Load a programmatically built graph (structured arrays)."""
        assert isinstance(weight, np.ndarray) and weight.dtype == T.Weight
        assert isinstance(variable, np.ndarray) and \
            variable.dtype == T.Variable
        assert isinstance(factor, np.ndarray) and factor.dtype == T.Factor
        assert isinstance(fmap, np.ndarray) and fmap.dtype == T.FactorToVar
        cg = compile_graph(weight, variable, factor, fmap,
                           factors_to_skip=factors_to_skip,
                           max_colors=self.max_colors,
                           domain_mask=domain_mask,
                           seed=self.seed,
                           cache=self.plan_cache or None)
        self.factorGraphs.append(
            FactorGraph(cg, len(self.factorGraphs), seed=self.seed))

    def loadFactorGraphRaw(self, cg, var_copies=1, weight_copies=1):
        """Load a pre-compiled graph (CompiledGraph), skipping compilation.

        Analog of the reference loadFactorGraphRaw (numbskull.py:183-190),
        which accepts a prebuilt vmap/factor_index; here the prebuilt
        artifact is the CompiledGraph (color plans included), e.g. from
        ``compile.compile_graph`` or a partitioner's per-part output.
        """
        self.factorGraphs.append(
            FactorGraph(cg, len(self.factorGraphs), seed=self.seed))

    def loadFGFromFile(self, directory=None, metafile=None, weightfile=None,
                       variablefile=None, factorfile=None, domainfile=None,
                       var_copies=1, weight_copies=1):
        """Load a DeepDive binary factor graph directory."""
        directory = directory or self.directory
        if not directory:
            print("No factor graph specified")
            return
        meta, weights, variables, factors, fmap, vmap, domain_mask = \
            dataloading.load_factor_graph_files(
                directory,
                metafile or self.metafile,
                weightfile or self.weightfile,
                variablefile or self.variablefile,
                factorfile or self.factorfile,
                domainfile or self.domainfile)
        if not self.quiet:
            print("Meta:")
            print("    weights:  ", meta["weights"])
            print("    variables:", meta["variables"])
            print("    factors:  ", meta["factors"])
            print("    edges:    ", meta["edges"])
        cg = compile_graph(weights, variables, factors, fmap,
                           max_colors=self.max_colors,
                           domain_values=vmap["value"],
                           domain_mask=domain_mask,
                           seed=self.seed,
                           cache=self.plan_cache or None)
        if not self.quiet:
            print("chromatic schedule: %d colors" % cg.n_colors)
        self.factorGraphs.append(
            FactorGraph(cg, len(self.factorGraphs), seed=self.seed))

    def loadFGFromDB(self, dburl=None, sql_filter: str = "1=1",
                     is_master: bool = True):
        """Load a (partition of a) factor graph from a database.

        Reference analog: master/minion Postgres ingest
        (salt/src/numbskull_master.py:327-346,
        salt/src/numbskull_minion.py:142-188). Accepts any DB-API URL
        handled by ``dbsource.connect`` (postgresql:// or sqlite://)."""
        from numbskull_jax import dbsource
        conn = dbsource.connect(dburl or self.dburl)
        try:
            cur = conn.cursor()
            (weight, variable, factor, fmap, domain_mask, edges,
             meta) = dbsource.get_fg_data(cur, sql_filter, is_master)
        finally:
            conn.close()
        if not self.quiet:
            print("DB graph: %d weights, %d variables, %d factors, "
                  "%d edges" % (len(weight), len(variable), len(factor),
                                edges))
        self.loadFactorGraph(weight, variable, factor, fmap, domain_mask,
                             edges)
        return meta

    def getFactorGraph(self, fgID: int = 0) -> FactorGraph:
        return self.factorGraphs[fgID]

    # --- inference / learning ----------------------------------------------

    def inference(self, fgID: int = 0, out: bool = True):
        fg = self.factorGraphs[fgID]
        fg.inference(self.burn_in, self.n_inference_epoch,
                     sample_evidence=self.sample_evidence,
                     diagnostics=not self.quiet,
                     checkpoint=self.checkpoint,
                     checkpoint_every=self.checkpoint_every)
        if out:
            os.makedirs(self.output_dir, exist_ok=True)
            fg.dump_probabilities(
                os.path.join(self.output_dir, "inference_result.out.text"),
                self.n_inference_epoch)

    def learning(self, fgID: int = 0, out: bool = True):
        fg = self.factorGraphs[fgID]
        # learning checkpoints live beside the inference checkpoint in
        # their own file (the two runs share the --checkpoint flag)
        ck = self.checkpoint + ".learn" if self.checkpoint else ""
        fg.learn(self.burn_in, self.n_learning_epoch, self.stepsize,
                 self.decay, self.regularization, self.reg_param,
                 self.truncation, diagnostics=not self.quiet,
                 verbose=self.verbose,
                 learn_non_evidence=self.learn_non_evidence,
                 grad_agg=self.grad_agg, checkpoint=ck,
                 checkpoint_every=self.checkpoint_every)
        if out:
            os.makedirs(self.output_dir, exist_ok=True)
            fg.dump_weights(os.path.join(
                self.output_dir, "inference_result.out.weights.text"))


def _distributed_arrays(ns: "NumbSkull"):
    """Raw full-graph arrays + optional DB partition metadata for the
    distributed runner."""
    if ns.dburl:
        from numbskull_jax import dbsource
        conn = dbsource.connect(ns.dburl)
        try:
            cur = conn.cursor()
            (weight, variable, factor, fmap, domain_mask, _e,
             meta) = dbsource.get_fg_data(cur, "1=1", is_master=True,
                                          mark_roles=False)
        finally:
            conn.close()
        return weight, variable, factor, fmap, domain_mask, meta
    meta_f, weight, variable, factor, fmap, vmap, domain_mask = \
        dataloading.load_factor_graph_files(
            ns.directory, ns.metafile, ns.weightfile, ns.variablefile,
            ns.factorfile, ns.domainfile)
    return weight, variable, factor, fmap, domain_mask, None


def run_distributed(ns: "NumbSkull", out: bool = True) -> dict:
    """One-command partitioned learning + inference.

    The reference's whole cluster flow — load, partition by cost,
    distributed learning with per-epoch weight-delta reduction at the
    master, distributed inference, text dumps, wall times returned —
    as a single call (reference salt/src/numbskull_master.py:547-584;
    scheme selection by cost numbskull_master.py:371-408). Partition
    candidates: the DB's semantic partition keys (when present) compete
    against connected-components packing and balanced region growing
    under one cost model; the cheapest wins.
    """
    from numbskull_jax.compile import conflict_edges
    from numbskull_jax.parallel.bsp import BSPEngine, factor_owner
    from numbskull_jax.parallel.partition import (choose_partition,
                                                  partition_cost)

    n_parts = max(int(ns.parts), 1)
    (weight, variable, factor, fmap, domain_mask,
     meta) = _distributed_arrays(ns)
    edges = conflict_edges(variable, factor, fmap)

    with Timer() as t_part:
        part, report = choose_partition(len(variable), edges, n_parts)
        if meta is not None and (np.asarray(meta["var_pid"]) >= 0).any():
            from numbskull_jax.dbsource import partition_from_keys
            kp = partition_from_keys(meta["var_pt"], meta["var_pid"])
            key_cost = partition_cost(len(variable), edges, kp,
                                      int(kp.max()) + 1)
            report["keys"] = key_cost
            if key_cost < report[report["chosen"]]:
                part, report["chosen"] = kp, "keys"

    mode = ns.dist_mode
    if mode == "auto":
        mode = "values"
        if meta is not None and "factor_ufo" in meta:
            owner = factor_owner(factor, fmap, part)
            fvid = fmap["vid"].astype(np.int64)
            arity = factor["arity"].astype(np.int64)
            edge_fid = np.repeat(np.arange(len(factor)), arity)
            straddles = np.zeros(len(factor), bool)
            np.logical_or.at(straddles, edge_fid,
                             part[fvid] != owner[edge_fid])
            if (meta["factor_ufo"] | ~straddles).all():
                mode = "messages"

    devices = jax.devices()
    eng = BSPEngine(weight, variable, factor, fmap, part, mode=mode,
                    domain_mask=domain_mask, max_colors=ns.max_colors,
                    seed=ns.seed,
                    devices=devices if len(devices) > 1 else None)
    lp = LearnParams(regularization=ns.regularization,
                     reg_param=ns.reg_param, truncation=ns.truncation,
                     learn_non_evidence=ns.learn_non_evidence,
                     grad_agg=ns.grad_agg)
    key = jax.random.PRNGKey(ns.seed)
    states = eng.init_states()
    with Timer() as t_learn:
        if ns.n_learning_epoch:
            states = eng.learn(states, jax.random.fold_in(key, 0),
                               epochs=ns.n_learning_epoch,
                               stepsize=ns.stepsize, decay=ns.decay,
                               burn=ns.burn_in, lp=lp)
        jax.block_until_ready(states[0].weight_value)
    with Timer() as t_inf:
        states = eng.inference(states, jax.random.fold_in(key, 1),
                               epochs=ns.n_inference_epoch,
                               burn=ns.burn_in,
                               sample_evidence=ns.sample_evidence)
        jax.block_until_ready(states[0].count)
    counts = eng.marginals(states, 1)
    weights_out = eng.weights(states)
    if out:
        os.makedirs(ns.output_dir, exist_ok=True)
        dump_weight_text(weights_out, os.path.join(
            ns.output_dir, "inference_result.out.weights.text"))
        dump_marginal_text(eng.engines[0].cg, counts,
                           ns.n_inference_epoch, os.path.join(
                               ns.output_dir, "inference_result.out.text"))
    result = {
        "n_parts": n_parts, "mode": mode, "partition": report["chosen"],
        "partition_s": t_part.interval,
        "learning_s": t_learn.interval, "inference_s": t_inf.interval,
        "traffic": eng.sync_traffic(),
        "part": part,                       # (V,) each variable's part
        # where each part's chain state ended up (one entry per part)
        "devices": [str(d) for s in states for d in s.count.devices()],
    }
    metrics.observe("distributed.learning_s", t_learn.interval)
    metrics.observe("distributed.inference_s", t_inf.interval)
    if not ns.quiet:
        print("DISTRIBUTED %d parts (%s, %s): learning %.3f s, "
              "inference %.3f s" %
              (n_parts, result["partition"], mode,
               t_learn.interval, t_inf.interval))
    return result


def load(argv=None) -> NumbSkull:
    """Parse CLI args, build a NumbSkull, load the graph directory."""
    if argv is None:
        argv = sys.argv[1:]
    parser = argparse.ArgumentParser(
        description="Runs a Gibbs sampler on a JAX device", epilog="")
    parser.add_argument("--version", action="version",
                        version="%(prog)s " + "0.1.0")
    for arg, opts in arguments:
        parser.add_argument(*arg, **opts)
    for arg, opts in flags:
        parser.add_argument(*arg, **opts)
    args = parser.parse_args(argv)
    ns = NumbSkull(**vars(args))
    if ns.parts and ns.parts > 1:
        return ns      # run_distributed loads its own raw arrays
    if ns.dburl:
        ns.loadFGFromDB()
    else:
        ns.loadFGFromFile()
    return ns


def main(argv=None):
    ns = load(argv)
    if ns.parts and ns.parts > 1:
        ns.distributed = run_distributed(ns)
    else:
        ns.learning()
        ns.inference()
    if ns.metrics_out:
        metrics.dump(ns.metrics_out)
    return ns
