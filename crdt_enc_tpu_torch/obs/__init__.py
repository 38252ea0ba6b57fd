"""Observability of the port: the port's copies of ``crdt_enc_tpu/obs``;
``tools.obs_report`` reads what they write.

* :mod:`.record` — the process-wide registry (spans with log-scale
  histograms, counters, counter taps, gauges, an event ring);
  ``crdt_enc_tpu_torch.utils.trace`` is the same module.
* :mod:`.replication` — the replication status math (watermark,
  backlog, divergence, checkpoint staleness) and its gauges.
* :mod:`.sink` — the JSONL metrics sink, its reader and schema check,
  and the Prometheus text exposition.
* :mod:`.slo` — the freshness and seal-latency objectives, a fold
  service cycle's burn, and window burn accounting over sink records.
* :mod:`.timeline` — Chrome-trace export of the event log (a lane per
  thread, counter tracks) and the chunk overlap check.
* :mod:`.attribution` — cycle attribution: stage marginals, the
  critical-path stage and the gap report.
* :mod:`.fleet` — per-device sink files merged into the fleet view, and
  the bench trend with its regression gate.
* :mod:`.live` — the live telemetry endpoint (``/metrics``,
  ``/healthz``, ``/snapshot``) on 127.0.0.1.
* :mod:`.runtime` — the port's runtime signals: kernel and native
  library builds, and the card's memory at fold boundaries.

Submodules import on demand, so importing the registry pulls nothing
else in.
"""
