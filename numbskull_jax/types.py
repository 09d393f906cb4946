"""Data model for numbskull-jax.

Two layers:

1. *Interop layer* — numpy structured dtypes byte-compatible with the
   reference's data model (reference: numbskull/numbskulltypes.py:11-39) so
   DeepDive grounding artifacts, programmatic graphs built for the reference
   API, and our C++ generator all plug in unchanged.

2. *Device layer* — the device representation is NOT these AoS records;
   `numbskull_jax.compile` lowers them to flat SoA int32/float32 arrays packed
   per color (see `compile.ColorPlan`). XLA wants flat typed buffers
   with static shapes, not structured records.
"""

from __future__ import annotations

import numpy as np

# --- Interop structured dtypes (match reference numbskulltypes.py) --------

Meta = np.dtype([("weights", np.int64),
                 ("variables", np.int64),
                 ("factors", np.int64),
                 ("edges", np.int64)])

Weight = np.dtype([("isFixed", np.bool_),
                   ("initialValue", np.float64)])

Variable = np.dtype([("isEvidence", np.int8),
                     ("initialValue", np.int64),
                     ("dataType", np.int16),
                     ("cardinality", np.int64),
                     ("vtf_offset", np.int64)])

Factor = np.dtype([("factorFunction", np.int16),
                   ("weightId", np.int64),
                   ("featureValue", np.float64),
                   ("arity", np.int64),
                   ("ftv_offset", np.int64)])

FactorToVar = np.dtype([("vid", np.int64),
                        ("dense_equal_to", np.int64)])

VarToFactor = np.dtype([("value", np.int64),
                        ("factor_index_offset", np.int64),
                        ("factor_index_length", np.int64)])

UnaryFactorOpt = np.dtype([("vid", np.int64),
                           ("weightId", np.int64)])


# --- Evidence codes (reference: numbskull/inference.py:21-24) --------------

EV_QUERY = 0      # free variable: always sampled
EV_EVIDENCE = 1   # observed: sampled only when sample_evidence
EV_NOT_OWNED = 4  # owned by another shard: never touched locally


# --- Factor function codes (reference: numbskull/inference.py:74-143) ------

FACTORS = {
    # Boolean-variable factor functions
    "NOOP": -1,
    "IMPLY_NATURAL": 0,
    "OR": 1,
    "AND": 2,
    "EQUAL": 3,
    "ISTRUE": 4,
    "LINEAR": 7,
    "RATIO": 8,
    "LOGICAL": 9,
    "IMPLY_MLN": 13,

    # Categorical-variable factor functions
    "AND_CAT": 12,
    "OR_CAT": 14,
    "EQUAL_CAT_CONST": 15,
    "IMPLY_NATURAL_CAT": 16,
    "IMPLY_MLN_CAT": 17,

    # Data-programming generative-model factor functions
    "DP_GEN_CLASS_PRIOR": 18,
    "DP_GEN_LF_PRIOR": 19,
    "DP_GEN_LF_PROPENSITY": 20,
    "DP_GEN_LF_ACCURACY": 21,
    "DP_GEN_LF_CLASS_PROPENSITY": 22,
    "DP_GEN_DEP_FIXING": 23,
    "DP_GEN_DEP_REINFORCING": 24,
    "DP_GEN_DEP_EXCLUSIVE": 25,
    "DP_GEN_DEP_SIMILAR": 26,

    # Distributed-support factor (carries per-value potential deltas)
    "UFO": 30,
}

# FUNC_* module-level constants, mirroring the reference's exec() loop.
_g = globals()
for _key, _value in FACTORS.items():
    _g["FUNC_" + _key] = _value

FUNC_UNDEFINED = -2

#: every implemented factor-function code, for validation
ALL_FUNC_CODES = frozenset(FACTORS.values())

#: max factor-function code + 1 (used to size lookup tables)
MAX_FUNC_CODE = max(FACTORS.values()) + 1


def new_weights(n: int) -> np.ndarray:
    return np.zeros(n, Weight)


def new_variables(n: int) -> np.ndarray:
    return np.zeros(n, Variable)


def new_factors(n: int) -> np.ndarray:
    return np.zeros(n, Factor)


def new_fmap(n: int) -> np.ndarray:
    return np.zeros(n, FactorToVar)
