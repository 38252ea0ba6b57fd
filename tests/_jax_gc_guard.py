"""An autouse fixture for the port's test files that drive the JAX
package's fold service, daemon or simulator beside the port.

The JAX warm tier drops an entry from a weakref finalizer that sets a
gauge (``crdt_enc_tpu/serve/warm.py:138-142`` → ``:96-100``) under the
JAX trace registry's non-reentrant ``_lock``
(``crdt_enc_tpu/obs/record.py:75``, taken at ``:286``).  A tenant state
that dies in a reference cycle (a ``Core`` and its key cryptor point at
each other) is freed by the cyclic collector, which runs that finalizer
on whatever thread it interrupts — and an automatic collection can start
at any allocation, including one made while that same thread holds
``_lock`` inside ``trace.add``, ``span`` or ``gauge``.  The thread then
waits on itself for ever: no test fails, the run is cut at its time
limit.

Import the fixture into a test module
(``from _jax_gc_guard import hold_the_cyclic_collector``) to keep automatic
collection off while the module's tests run and collect once after the
last, on the main thread, outside every lock.  Reference counting still
frees acyclic garbage as it goes.  One collection a module, not one a
test: with JAX and torch loaded a full collection walks every live
object, and a module's cyclic garbage is small.  Nothing the JAX package
or the port computes changes, and no JAX file is edited.
"""

from __future__ import annotations

import gc

import pytest


@pytest.fixture(scope="module", autouse=True)
def hold_the_cyclic_collector():
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        gc.collect()
        if was_enabled:
            gc.enable()
