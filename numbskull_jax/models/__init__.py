"""Factor-graph model families (host-side generators).

These are equivalents of the reference's graph generators:
ising/ising.cpp (Ising grid, coin model), test_lf_learning.py's
labeling-function generative model, and the voting-app generators under
experiments/. Each returns the `(weight, variable, factor, fmap,
domain_mask, edges)` tuple accepted by `NumbSkull.loadFactorGraph`.
"""

from numbskull_jax.models.ising import (  # noqa: F401
    ising_color_hint, ising_grid, potts_grid,
)
from numbskull_jax.models.coin import coin_model, coin_exact_marginal  # noqa: F401
from numbskull_jax.models.lf import lf_model, lf_exact_cdf  # noqa: F401
from numbskull_jax.models.voting import (  # noqa: F401
    voting_grouped, voting_model,
)
from numbskull_jax.models.replicate import (  # noqa: F401
    pool_chain_counts, replicate_graph,
)
