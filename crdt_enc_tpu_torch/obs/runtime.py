"""Runtime signals of the port: library builds and the card's memory.

The port's twin of ``crdt_enc_tpu/obs/runtime.py``.  The JAX package
counts XLA recompiles: a jitted program compiles once per shape class,
so a fold loop whose compile count grows is broken.  Eager PyTorch
compiles nothing per shape; the port's only compiles are its libraries,
each built once per source hash at first use:

* **Build counter** (:func:`note_build`): every CUDA kernel library built
  by ``ops/cuda_build.py`` bumps ``cuda_builds`` and every native C++
  library built by ``native/__init__.py`` bumps ``native_builds``; each
  build's wall lands under the ``build.cuda`` / ``build.native`` span.
  :func:`build_count` is their sum.  A steady-state fold service cycle
  must leave it unchanged: a build there means a library was keyed on
  something that varies per call.
* **Device memory** (:func:`sample_device_memory`): the
  ``device_bytes_in_use`` / ``device_peak_bytes`` gauges from
  ``torch.cuda.memory_stats`` of the card, sampled at fold boundaries
  (the fold service samples after each bucket).  Returns None for the
  CPU, where there is no allocator to read.

Nothing here imports torch at module load.
"""

from __future__ import annotations

from . import record

BUILD_COUNTERS = ("cuda_builds", "native_builds")


def note_build(kind: str, seconds: float, n: int = 1) -> None:
    """Record ``n`` library builds of ``kind`` ("cuda" or "native") that
    took ``seconds`` of wall together."""
    if kind == "cuda":
        record.add("cuda_builds", n)
        record.observe("build.cuda", seconds)
    elif kind == "native":
        record.add("native_builds", n)
        record.observe("build.native", seconds)
    else:
        raise ValueError(f"unknown library kind {kind!r}")


def build_count() -> int:
    """Every library build recorded since the registry's last reset."""
    counters = record.snapshot()["counters"]
    return sum(counters.get(k, 0) for k in BUILD_COUNTERS)


def sample_device_memory(device=None) -> dict | None:
    """Set the ``device_bytes_in_use`` / ``device_peak_bytes`` gauges
    from the caching allocator of ``device`` (a CUDA device; ``None``
    means the current one) and return the raw stats, or return None
    without sampling when ``device`` is not a CUDA device or no card is
    present."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    record.gauge("device_bytes_in_use",
                 int(stats.get("allocated_bytes.all.current", 0)))
    record.gauge("device_peak_bytes",
                 int(stats.get("allocated_bytes.all.peak", 0)))
    return stats
