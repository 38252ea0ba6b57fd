"""Composed adapters via semidirect products — new CRDT types, zero
new device kernels.  The port's copy of ``crdt_enc_tpu/delta/compose.py``.

"Composing and Decomposing Op-Based CRDTs with Semidirect Products"
(arXiv:2004.04303) builds richer types as a product ``A ⋊ B`` where
``B``'s operations *act on* ``A``'s: the composed op set is the union,
and a ``B`` op rewrites the effect of every concurrent-or-prior ``A``
op it observed.  The resettable counter is the canonical instance —
increments (``A``) composed with resets (``B``) whose action cancels
every increment the reset observed, while concurrent unobserved
increments survive.

That action law — "cancel what you observed, spare what you didn't" —
is exactly the observed-remove discipline the Orswot OR-Set already
implements with its causal clock (``models/orset.py``).  So the
composition here is *representational*: a resettable counter state IS
an OR-Set whose members are **increment tokens** (one unique token per
increment, carrying its amount), and the composed ops ARE OR-Set ops:

* ``inc(amount)``   → ``AddOp(token, dot)`` — the token's dot is the
  increment's identity in the product;
* ``reset()``       → one ``RmOp`` per live token (the semidirect
  action: remove-what-you-observed);
* ``value()``       → sum of live tokens' amounts;
* ``undo(token)``   → ``RmOp`` for that single token.

Because the state is a real :class:`~crdt_enc_tpu_torch.models.ORSet`,
the whole existing stack serves it unchanged: the CUDA OR-Set fold and
merge kernels, the fold sessions, the device plane cache, the packed
checkpoints, and the delta codec (``delta/codec.py`` registers
``b"rcounter"`` onto the OR-Set codec).
The adapter below differs from ``orset_adapter`` only in name — the
name is the contract (it selects codecs), the kernels are shared.

**Undo scope** — "The Only Undoable CRDTs are Counters"
(arXiv:2006.10494) proves that exact, order-agnostic undo exists only
for commutative-monoid effects (counters): un-incrementing is adding
the inverse.  Accordingly :meth:`ResettableCounter.undo` undoes
*increments* (token removal is the exact inverse, and it commutes),
and **resets are not undoable**: un-removing an Orswot token would
need a fresh dot, which is a new event, not an inverse — concurrent
peers could have observed the reset and the "undo" would resurrect
state some replicas legitimately dropped.  ``undo`` on a reset (or on
an already-cancelled token) raises :class:`UndoError` instead of
guessing.
"""

from __future__ import annotations

from ..models import ORSet
from ..models.orset import AddOp, RmOp, op_from_obj as orset_op_from_obj
from ..models.vclock import Actor
from ..utils import codec as _codec


class UndoError(Exception):
    """The requested undo is outside the honest undo scope: the target
    increment is no longer observable (already reset/undone/unseen),
    or the op kind (reset) admits no inverse (arXiv:2006.10494)."""


def _token(actor: Actor, counter: int, amount: int) -> bytes:
    """One increment token: unique per (actor, dot counter), carrying
    its amount.  Packed canonically so tokens sort deterministically
    in the OR-Set's member table."""
    return _codec.pack([b"inc", bytes(actor), int(counter), int(amount)])


def _token_amount(member) -> int | None:
    try:
        kind, _actor, _counter, amount = _codec.unpack(bytes(member))
    except Exception:
        return None
    if bytes(kind) != b"inc":
        return None
    return int(amount)


class ResettableCounter:
    """Op builders + reads over an OR-Set-typed state.  Stateless —
    every method takes the live state (use them inside
    ``core.with_state`` / ``core.update`` sections, where the LockBox
    discipline holds)."""

    # -- ops ---------------------------------------------------------------
    @staticmethod
    def inc(state: ORSet, actor: Actor, amount: int = 1) -> AddOp:
        """One increment as a composed op: a unique valued token added
        with the next dot.  Returns the ``AddOp`` (apply via the core's
        normal op path); the op's ``member`` is the undo handle."""
        if amount == 0:
            raise ValueError("amount must be non-zero")
        dot = state.clock.inc(actor)
        return AddOp(_token(dot.actor, dot.counter, amount), dot)

    @staticmethod
    def reset(state: ORSet) -> list[RmOp]:
        """The semidirect action: cancel every increment this replica
        has observed.  Concurrent increments it has NOT observed
        survive the reset — the add-wins window the product
        construction prescribes."""
        return [state.rm_ctx(m) for m in state.members()]

    @staticmethod
    def undo(state: ORSet, op) -> RmOp:
        """Undo one observed increment (its exact inverse).  Raises
        :class:`UndoError` when ``op`` is not an increment or its token
        is no longer live (already reset or undone — there is nothing
        left to invert)."""
        if isinstance(op, RmOp):
            raise UndoError(
                "resets are not undoable: un-removing would mint a new "
                "event, not an inverse (arXiv:2006.10494)"
            )
        member = op.member if isinstance(op, AddOp) else op
        if _token_amount(member) is None:
            raise UndoError(f"not an increment token: {member!r}")
        if not state.contains(member):
            raise UndoError("increment no longer observable (reset/undone)")
        return state.rm_ctx(member)

    # -- reads -------------------------------------------------------------
    @staticmethod
    def value(state: ORSet) -> int:
        total = 0
        for member in state.entries:
            amount = _token_amount(member)
            if amount is not None:
                total += amount
        return total

    @staticmethod
    def tokens(state: ORSet) -> list[tuple[bytes, int]]:
        """Live (token, amount) pairs — the auditable increment
        history the undo API addresses."""
        out = []
        for member in state.members():
            amount = _token_amount(member)
            if amount is not None:
                out.append((bytes(member), amount))
        return out


def rcounter_adapter():
    """The composed resettable counter as a Core adapter: OR-Set state,
    OR-Set wire, OR-Set kernels — only the name (and therefore the
    codec dispatch) differs: a new user-facing CRDT type with no new
    device kernel."""
    from ..core.adapters import CrdtAdapter

    return CrdtAdapter(
        name=b"rcounter",
        new=ORSet,
        state_from_obj=ORSet.from_obj,
        op_from_obj=orset_op_from_obj,
    )
