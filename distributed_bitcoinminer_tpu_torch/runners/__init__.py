"""Interactive LSP echo runners over the port's transport, flag-compatible
with the reference harness (its ``srunner`` and ``crunner``); the
counterparts of the JAX package's ``runners/``."""
