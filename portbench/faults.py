"""The control and the planted faults, for the checks of ``correct``.

Never part of a benchmark run: ``python3 -m portbench.run ... --fault
NAME`` plants one under the timed path, and the tests under
``portbench/tests`` see ``correct`` come out false.

- ``control``: the configuration's guarantee broken once: one stored op
  file (the last of the first actor by id) is not folded into the
  snapshot.
- ``unchanged``: the compaction returns its state unchanged: it reads no
  op file and no snapshot.
- ``half``: half of the batch left out: the op files of every other actor
  (by the parity of the id's first byte) are not read.
- ``alter``: an answer altered where it is produced: one live value of
  the folded state is raised by one before the seal, chosen by the
  state's type (:data:`ALTER`): an OR-Set's counter of its least member
  and actor, an LWW map's timestamp of its first live key.
"""

from __future__ import annotations

import contextlib

NAMES = ("control", "unchanged", "half", "alter")


def _hider(name: str, storage):
    cls = type(storage)

    class Hiding(cls):
        def _hidden(self, wanted) -> set | None:
            if name == "unchanged":
                return None  # everything
            if name == "half":
                return {a for a, _ in wanted if a[0] % 2 == 0}
            return set()

        def _keep(self, wanted):
            hidden = self._hidden(wanted)
            target = min((a for a, _ in wanted), default=None)

            def keep(f) -> bool:
                actor, version = f[0], f[1]
                if hidden is None or actor in hidden:
                    return False
                if name == "control" and actor == target:
                    return version < self._last.get(actor, 0)
                return True

            return keep

        async def _versions(self, wanted) -> None:
            self._last = {}
            if name == "control" and wanted:
                target = min(a for a, _ in wanted)
                for a, v, _ in await cls.load_ops(self, [(target, 1)]):
                    self._last[a] = max(self._last.get(a, 0), v)

        async def load_ops(self, wanted):
            await self._versions(wanted)
            keep = self._keep(wanted)
            return [f for f in await cls.load_ops(self, wanted) if keep(f)]

        async def iter_op_chunks(self, wanted, *args, **kw):
            await self._versions(wanted)
            keep = self._keep(wanted)
            async for chunk in cls.iter_op_chunks(self, wanted, *args, **kw):
                part = [f for f in chunk if keep(f)]
                if part:
                    yield part

        async def list_state_names(self):
            if name == "unchanged":
                return []
            return await cls.list_state_names(self)

    return Hiding


def wrap(storage, name: str):
    """``storage`` with the fault's reads planted (``alter`` plants none
    here: see :func:`scope`)."""
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
    if name != "alter":
        storage.__class__ = _hider(name, storage)
    return storage


def _alter_orset(state) -> None:
    if state.entries:
        m = min(state.entries)
        state.entries[m][min(state.entries[m])] += 1


def _alter_lwwmap(state) -> None:
    live = state.keys()
    if live:
        state.entries[live[0]][0] += 1


# the program's state type's name -> how ``alter`` changes one live value
ALTER = {"ORSet": _alter_orset, "LWWMap": _alter_lwwmap}


def alter(state) -> None:
    """Raise one live value of ``state`` by one, by its type."""
    kind = type(state).__name__
    if kind not in ALTER:
        raise TypeError(f"the alter fault has no alteration for a {kind} "
                        f"state; it alters {sorted(ALTER)}")
    ALTER[kind](state)
    state._mut += 1


@contextlib.contextmanager
def scope(name: str):
    """Around the timed path: ``alter`` raises one live value of the
    state before every seal."""
    if name != "alter":
        yield
        return
    from crdt_enc_tpu_torch.core.core import Core

    original = Core._compact_seal

    async def altered(self, **kw):
        alter(self._data.state)
        kw.pop("_state_obj", None)
        kw.pop("_packed_state", None)
        return await original(self, **kw)

    Core._compact_seal = altered
    try:
        yield
    finally:
        Core._compact_seal = original
