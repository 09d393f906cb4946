"""python -m numbskull_jax (reference: numbskull/__main__.py)."""

from numbskull_jax.numbskull import main

main()
