"""numbskull-jax: a Gibbs-sampling and weight-learning engine for factor
graphs, written in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
HazyResearch/numbskull (DeepDive / DimmWitted ecosystem): loads DeepDive
binary grounding output, runs chromatic Gibbs inference over boolean and
categorical variables, and learns factor weights by dual-chain SGD — as
fused vectorized device programs sharded over a `jax.sharding.Mesh`
instead of hogwild CPU threads and SaltStack clusters.
"""

import os
import warnings

__version__ = "0.1.0"

#: the environment settings this package reads (native helper paths)
ENV_SETTINGS = ("NUMBSKULL_JAX_COMPILECORE", "NUMBSKULL_JAX_FASTLOAD")


def warn_unknown_settings(environ=os.environ) -> list:
    """Warn about every ``NUMBSKULL_*`` variable that is not one of
    ``ENV_SETTINGS`` (a misspelt name, or one of an older release), which
    would otherwise be ignored without a word. Returns their names."""
    unknown = sorted(k for k in environ
                     if k.startswith("NUMBSKULL_") and k not in ENV_SETTINGS)
    for k in unknown:
        warnings.warn("%s is ignored: numbskull_jax reads only %s" % (
            k, ", ".join(ENV_SETTINGS)), stacklevel=2)
    return unknown

#: persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at a fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here. Otherwise the cache goes to
    ``<checkout>/.jax_cache``: a fixed path, so one run's compiled
    programs are found again by the next. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    return DEFAULT_COMPILE_CACHE


configure_compile_cache()
warn_unknown_settings()

from numbskull_jax import dataloading  # noqa: F401,E402
from numbskull_jax import dbsource  # noqa: F401,E402
from numbskull_jax import observability  # noqa: F401,E402
from numbskull_jax import resilience  # noqa: F401,E402
from numbskull_jax.checkpoint import (  # noqa: F401,E402
    load_checkpoint, save_checkpoint,
)
from numbskull_jax import types  # noqa: F401,E402
from numbskull_jax.compile import compile_graph, CompiledGraph  # noqa: F401,E402
from numbskull_jax.numbskull import NumbSkull, load, main  # noqa: F401,E402
from numbskull_jax.ops import GibbsEngine, SamplerState, LearnParams  # noqa: F401,E402
from numbskull_jax.types import FACTORS  # noqa: F401,E402
