"""Device compute: factor evaluation, sampling, Gibbs/SGD sweeps."""

from numbskull_jax.ops.factor_eval import eval_factors, present_types_of  # noqa: F401
from numbskull_jax.ops.sample import draw  # noqa: F401
from numbskull_jax.ops.gibbs import (  # noqa: F401
    GibbsEngine, SamplerState, LearnParams,
)
