"""DET001 — sim-replayable surfaces stay bit-deterministic, statically.

The population runner's contract is that a schedule replays to a
bit-identical fingerprint.  That holds only while every entropy source
on a replayable surface goes through a seeded seam.  This rule checks
the propagated ``wall_clock``/``rng`` effect sets of every function in
``sim/`` and the schedule-driven daemon module, with the seams the
runtime actually provides carved out:

* ``uuid4``/``uuid1`` origins — the sim installs a refcounted,
  ContextVar-dispatched ``uuid.uuid4`` patch (``sim/runner.py``), so a
  uuid draw on a replayable surface IS seeded at replay time;
* wall-clock reads whose *direct origin* lives in
  ``crdt_enc_tpu_torch/obs/`` — telemetry timestamps annotate spans and
  live dashboards and never enter fingerprints or schedule decisions;
* seeded constructions are invisible by design: ``random.Random(seed)``
  is not an rng effect, ``clock=``/``on_poll=`` parameters resolve to
  injected callables (honestly reported as unresolved, not guessed),
  and SHA-256 fault rolls are hashes, not entropy.

The runtime half (the simulator actually replaying and comparing
fingerprints) still exists — this rule is the cheap static half that
fails a violating call chain in seconds instead of needing an all-fault
schedule to fire.  Effects arriving *via* another on-surface function
are reported there, once.
"""

from __future__ import annotations

from ..effects import KIND_RNG, KIND_WALL, effect_index
from ..engine import PKG_PREFIX, SEV_ERROR, Finding, Project, rule

_SURFACE_PREFIXES = (PKG_PREFIX + "sim/",)
_SURFACE_FILES = (PKG_PREFIX + "serve/daemon.py",)

#: uuid draws go through the sim's ContextVar dispatch seam
_SANCTIONED_ORIGINS = ("uuid4", "uuid1", "uuid.uuid4", "uuid.uuid1")
#: wall-clock reads rooted in obs/ are telemetry, never replay inputs
_TELEMETRY_PREFIX = PKG_PREFIX + "obs/"


def _on_surface(rel: str) -> bool:
    return rel.startswith(_SURFACE_PREFIXES) or rel in _SURFACE_FILES


def _direct_origin_rel(idx, key: str, kind: str, origin: str) -> str | None:
    """Follow via-links to the file containing the direct origin."""
    seen: set[str] = set()
    k: str | None = key
    while k and k not in seen:
        seen.add(k)
        fi = idx.funcs.get(k)
        if fi is None:
            return None
        prov = fi.effects.get((kind, origin))
        if prov is None:
            return None
        if prov.via is None:
            return prov.rel
        k = prov.via
    return None


@rule("DET001", SEV_ERROR)
def determinism_on_sim_surfaces(project: Project):
    """No wall_clock/rng effect may reach a sim-replayable surface
    except via the seeded seams (ContextVar uuid dispatch, obs-rooted
    telemetry clocks, seeded constructors)."""
    idx = effect_index(project)
    for fi in idx.funcs.values():
        if not _on_surface(fi.mod.rel):
            continue
        for (kind, origin), prov in sorted(fi.effects.items()):
            if kind not in (KIND_WALL, KIND_RNG):
                continue
            if origin in _SANCTIONED_ORIGINS or origin.rsplit(".", 1)[-1] in (
                "uuid4",
                "uuid1",
            ):
                continue
            if prov.via:
                callee = idx.funcs.get(prov.via)
                if callee is not None and _on_surface(callee.mod.rel):
                    continue  # reported at the inner surface boundary
            if kind == KIND_WALL:
                root = _direct_origin_rel(idx, fi.key, kind, origin)
                if root is not None and root.startswith(_TELEMETRY_PREFIX):
                    continue
            chain = idx.chain(fi.key, kind, origin)
            yield Finding(
                rule="DET001",
                severity=SEV_ERROR,
                path=fi.mod.rel,
                line=prov.line,
                context=fi.qualname,
                message=(
                    f"replayable surface reaches {kind} effect `{origin}` "
                    "— route it through a seeded seam (clock= param, "
                    "ContextVar uuid dispatch, SHA-256 roll) or baseline "
                    "with a reason"
                ),
                chain=chain,
            )
