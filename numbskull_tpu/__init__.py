"""The package's former import name, kept as an alias of ``numbskull_jax``.

Importing it, or any of its submodules, gives the very module objects of
``numbskull_jax``, so existing imports and pickles keep working. New code
imports ``numbskull_jax``.
"""

import importlib
import pkgutil
import sys

import numbskull_jax

for _m in pkgutil.walk_packages(numbskull_jax.__path__, "numbskull_jax."):
    if not _m.name.endswith(".__main__"):
        sys.modules[__name__ + _m.name[len("numbskull_jax"):]] = \
            importlib.import_module(_m.name)
sys.modules[__name__] = numbskull_jax
