"""LockBox: the no-await data-lock discipline as a runtime *mechanism*.

The port's copy of ``crdt_enc_tpu/utils/lockbox.py``.

The reference's ``LockBox`` (crdt-enc/src/utils/mod.rs:165-195) is a sync
mutex wrapper whose API makes holding the guard across an ``await``
unrepresentable at compile time: the closure passed to ``with_`` is
synchronous, so the borrow cannot outlive the call.  Python cannot forbid
this statically, so this module enforces the same contract at runtime:

* ``LockBox.with_(fn)`` runs a **synchronous** ``fn(value)`` — coroutine
  functions are rejected up front, and a returned awaitable/generator
  (the sneaky way to smuggle the borrow across a suspension point) is
  rejected after the fact.
* ``fn`` receives a revocable **borrow proxy**, not the value itself.  At
  section exit the proxy is revoked; any retained reference that is used
  later — the Python shape of "held the lock across an await" — raises
  ``LockBoxViolation`` at the exact use site instead of racing silently.

The proxy layer is active only under ``__debug__`` (i.e. not with
``python -O``), mirroring a debug-mode borrow checker: release builds pay
nothing, test/dev builds turn the convention into a hard error.
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Callable, TypeVar

T = TypeVar("T")

class LockBoxViolation(RuntimeError):
    """A LockBox borrow escaped its synchronous section and was used."""


class _Borrow:
    """Revocable attribute-forwarding proxy around the guarded value."""

    __slots__ = ("_lockbox_value", "_lockbox_alive")

    def __init__(self, value: Any):
        object.__setattr__(self, "_lockbox_value", value)
        object.__setattr__(self, "_lockbox_alive", True)

    def _check(self) -> Any:
        if not object.__getattribute__(self, "_lockbox_alive"):
            raise LockBoxViolation(
                "LockBox borrow used outside its synchronous section — the "
                "guarded value was retained across a suspension point "
                "(reference utils/mod.rs:165-195 forbids this by type)"
            )
        return object.__getattribute__(self, "_lockbox_value")

    def __getattr__(self, name: str) -> Any:
        return getattr(self._check(), name)

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._check(), name, value)

    def __delattr__(self, name: str) -> None:
        delattr(self._check(), name)

    def __repr__(self) -> str:
        return f"<LockBox borrow of {self._check()!r}>"

    # Implicit special-method lookup skips __getattr__, so the protocol
    # operations the CRDT models implement are forwarded explicitly —
    # without these, `s == other` inside a section would silently fall
    # back to object identity and `len(s)` would raise.
    def __eq__(self, other):
        return self._check() == other

    def __ne__(self, other):
        return self._check() != other

    def __hash__(self):
        return hash(self._check())

    def __len__(self):
        return len(self._check())

    def __iter__(self):
        return iter(self._check())

    def __contains__(self, item):
        return item in self._check()

    def __getitem__(self, key):
        return self._check()[key]

    def __setitem__(self, key, value):
        self._check()[key] = value

    def __bool__(self):
        return bool(self._check())


class LockBox:
    """Holds one mutable value; grants access only inside synchronous
    ``with_`` sections.  asyncio's run-to-completion of sync code is the
    mutual exclusion (single event loop); this class enforces that the
    section really is synchronous and that the borrow does not escape."""

    __slots__ = ("_value",)

    def __init__(self, value: T):
        self._value = value

    def with_(self, fn: Callable[[T], Any]) -> Any:
        if asyncio.iscoroutinefunction(fn):
            raise TypeError("LockBox sections must be synchronous callables")
        if not __debug__:
            return fn(self._value)
        borrow = _Borrow(self._value)
        try:
            out = fn(borrow)
        finally:
            object.__setattr__(borrow, "_lockbox_alive", False)
        if inspect.isawaitable(out) or inspect.isgenerator(out):
            raise TypeError(
                "LockBox section returned a suspendable object "
                f"({type(out).__name__}); the borrow must not cross awaits"
            )
        return out
