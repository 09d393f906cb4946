"""The package's import-time set-up: the alias under its former name and
the warning about environment settings it does not read."""

import importlib
import os
import pkgutil

import pytest

import numbskull_jax
import numbskull_jax.numbskull

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_former_import_name_is_an_alias():
    """The other ``numbskull_*`` package at the root of the checkout (the
    former name) resolves to this package's own module objects."""
    (old,) = [m.name for m in pkgutil.iter_modules([ROOT])
              if m.ispkg and m.name.startswith("numbskull_")
              and m.name != "numbskull_jax"]
    assert importlib.import_module(old) is numbskull_jax
    assert importlib.import_module(old + ".numbskull") is \
        numbskull_jax.numbskull
    assert importlib.import_module(old + ".parallel.bsp").BSPEngine is \
        importlib.import_module("numbskull_jax.parallel.bsp").BSPEngine


def test_unknown_settings_warn():
    env = {"NUMBSKULL_JAX_FASTLOAD": "x", "NUMBSKULL_COMPILECORE": "off",
           "HOME": "/h"}
    with pytest.warns(UserWarning, match="NUMBSKULL_COMPILECORE is ignored"):
        got = numbskull_jax.warn_unknown_settings(env)
    assert got == ["NUMBSKULL_COMPILECORE"]
