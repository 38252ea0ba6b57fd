"""Observability of the port: the port's copies of the parts of
``crdt_enc_tpu/obs`` its core and fold service call.

* :mod:`.record` — the process-wide registry (spans with log-scale
  histograms, counters, counter taps, gauges, an event ring);
  ``crdt_enc_tpu_torch.utils.trace`` is the same module.
* :mod:`.replication` — the replication status math (watermark,
  backlog, divergence, checkpoint staleness) and its gauges.
* :mod:`.sink` — the JSONL metrics sink and the Prometheus text
  exposition.
* :mod:`.slo` — the freshness and seal-latency objectives and a fold
  service cycle's burn.
* :mod:`.live` — the live telemetry endpoint (``/metrics``,
  ``/healthz``, ``/snapshot``) on 127.0.0.1.
* :mod:`.runtime` — the port's runtime signals: kernel and native
  library builds, and the card's memory at fold boundaries.

Submodules import on demand, so importing the registry pulls nothing
else in.
"""
