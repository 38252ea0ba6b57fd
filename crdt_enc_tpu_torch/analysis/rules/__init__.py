"""Rule plugins.  Importing this package registers every rule with the
engine registry (``crdt_enc_tpu_torch.analysis.engine.rule``); adding a
rule is: write a module here, decorate the entry point and import it
below.  The port has no ``jax.jit``, so the JIT001/JIT002 rules of a JAX
tree have no twin here."""

from . import (  # noqa: F401
    async_,
    determinism,
    exc,
    ffi,
    locks,
    mutation,
    obs,
    sec,
    spans,
    threads,
)
