"""Live telemetry plane: a scrapeable in-process HTTP endpoint.

The port's copy of ``crdt_enc_tpu/obs/live.py`` on the standard
library's ``http.server``.  It computes no signal of its own; it serves
what the registry and the replication sampler maintain:

* ``GET /metrics``  — the live registry rendered by
  :func:`obs.sink.to_prometheus`, content type
  ``text/plain; version=0.0.4``.
* ``GET /healthz``  — JSON, schema-stamped like a sink record: per-remote
  device health (the watermark, backlog and divergence each
  ``Core.replication_status()`` computed at its last sample, and the
  watermark's age) plus the last published service-cycle summaries.
* ``GET /snapshot`` — the full ``record.snapshot()`` as JSON.

Never on the hot path: the server runs ``serve_forever`` on one daemon
thread, and publishing into it is a dict store under a lock; with no
server configured :func:`publish` is one global check.

Opt in with ``CRDT_OBS_HTTP=<port>`` (or ``<host>:<port>``; a plain port
binds 127.0.0.1), or pass ``FoldService(..., live_port=...)`` for a
service-owned instance, or drive :class:`LiveTelemetryServer` directly.
``port=0`` binds an ephemeral port; :func:`shutdown` stops the default
server.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import record, sink

logger = logging.getLogger("crdt_enc_tpu_torch.obs.live")

ENV_VAR = "CRDT_OBS_HTTP"

#: /healthz keeps only the bounded summary of a replication status —
#: the cursor matrix grows with (replicas × actors) and belongs in the
#: sink record, not in every scrape response.
_HEALTH_KEYS = (
    "watermark", "backlog", "divergence", "checkpoint", "local_clock",
    # present only when a strong-read membership policy is configured
    # (read/policy.py): who the watermark denominator excludes must be
    # operator-visible, never a silent drop
    "membership",
)


class _Handler(BaseHTTPRequestHandler):
    server_version = "crdt-obs-live"
    protocol_version = "HTTP/1.1"
    # keep-alive needs an idle bound: without it every half-open or
    # silent connection pins one ThreadingHTTPServer thread for good.
    # On timeout the handler closes the connection and the thread exits.
    timeout = 30.0

    def handle_one_request(self):
        # a scraper dropping its connection (timeout, RST) is routine
        # for a long-lived service: both the in-flight response write
        # and the keep-alive loop's next request read die with a pipe
        # error that socketserver would otherwise print as a full
        # stderr traceback per dropped scrape
        try:
            super().handle_one_request()
        except (BrokenPipeError, ConnectionResetError):
            logger.debug("telemetry client disconnected")
            self.close_connection = True

    def do_GET(self):  # noqa: N802 — http.server's fixed method name
        with record.span("obs.live.request", meta=self.path):
            record.add("live_requests", 1)
            try:
                if self.path == "/metrics":
                    body = sink.to_prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/healthz":
                    body = json.dumps(
                        self.server.telemetry.health(), sort_keys=True
                    ).encode()
                    ctype = "application/json"
                elif self.path == "/snapshot":
                    body = json.dumps(
                        {"schema": sink.SCHEMA_VERSION, **record.snapshot()},
                        sort_keys=True,
                    ).encode()
                    ctype = "application/json"
                else:
                    body = b"not found\n"
                    self._reply(404, "text/plain", body)
                    return
            except Exception as e:  # telemetry must not take itself down
                logger.debug("telemetry request failed", exc_info=True)
                self._reply(500, "text/plain", f"{e!r}\n".encode())
                return
            self._reply(200, ctype, body)

    def _reply(self, code: int, ctype: str, body: bytes) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # a scraper timing out mid-response is routine in a
            # long-lived service — not a stderr traceback per scrape
            logger.debug("telemetry client disconnected mid-response")
            self.close_connection = True

    def log_message(self, fmt, *args):
        logger.debug("live: " + fmt, *args)


class LiveTelemetryServer:
    """One embeddable telemetry endpoint (module docs).

    ``start()`` binds and returns the port (use ``port=0`` for an
    ephemeral one); ``stop()`` shuts the listener down gracefully —
    in-flight requests finish, the socket closes, the thread joins.
    ``publish_health``/``publish_cycle`` are the write side the
    replication sampler and the fold service feed; ``health()`` is the
    read side ``/healthz`` renders."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.host = host
        self.port = int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # (remote_id hex, actor hex) -> bounded status summary + ts
        self._devices: dict[tuple[str, str], dict] = {}
        # source name -> last cycle summary (FoldService)
        self._cycles: dict[str, dict] = {}

    # ---------------------------------------------------------- lifecycle
    @property
    def running(self) -> bool:
        return self._httpd is not None

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port.
        Idempotent — a running server keeps its port."""
        if self._httpd is not None:
            return self.port
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.telemetry = self
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=f"crdt-obs-live-{self.port}",
            daemon=True,
        )
        self._thread.start()
        logger.debug("live telemetry serving on %s:%d", self.host, self.port)
        return self.port

    def stop(self) -> None:
        """Graceful shutdown: stop accepting, close the socket, join."""
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    # --------------------------------------------------------- write side
    def publish_health(self, status: dict, ts: float | None = None) -> None:
        """Store one device's replication status summary (the dict
        ``Core.replication_status()`` returns).  Bounded: only the
        ``_HEALTH_KEYS`` summary is kept, last write per (remote,
        actor) wins.  The publish time the WATERMARK last changed is
        tracked separately (``watermark_ts``) so ``/healthz`` can
        report watermark AGE: a wedged watermark (fresh samples, stale
        frontier) is an operator-visible duration."""
        key = (status.get("remote_id", "?"), status.get("actor", "?"))
        entry = {k: status[k] for k in _HEALTH_KEYS if k in status}
        entry["ts"] = round(time.time() if ts is None else ts, 3)
        with self._lock:
            old = self._devices.get(key)
            if (
                old is not None
                and old.get("watermark") == entry.get("watermark")
            ):
                entry["watermark_ts"] = old.get("watermark_ts", entry["ts"])
            else:
                entry["watermark_ts"] = entry["ts"]
            self._devices[key] = entry

    def publish_cycle(self, source: str, summary: dict) -> None:
        """Store a service-cycle summary (tenant counts, paths, SLO burn
        — whatever the publisher considers its last-cycle status)."""
        with self._lock:
            self._cycles[source] = dict(summary)

    # ---------------------------------------------------------- read side
    def health(self) -> dict:
        """The ``/healthz`` payload: schema-stamped like a sink record,
        devices grouped per remote, plus last-cycle summaries."""
        with self._lock:
            devices = {k: dict(v) for k, v in self._devices.items()}
            cycles = {k: dict(v) for k, v in self._cycles.items()}
        now = time.time()
        remotes: dict[str, dict] = {}
        for (remote_id, actor), entry in sorted(devices.items()):
            # watermark AGE: how long since this device's stability
            # watermark last moved — a wedged watermark shows as a
            # growing duration right in /healthz
            wm_ts = entry.pop("watermark_ts", None)
            if wm_ts is not None:
                entry["watermark_age_s"] = round(max(0.0, now - wm_ts), 3)
            slot = remotes.setdefault(remote_id, {"devices": {}})
            slot["devices"][actor] = entry
            age = entry.get("watermark_age_s")
            if age is not None:
                slot["watermark_age_s"] = max(
                    slot.get("watermark_age_s", 0.0), age
                )
        return {
            "schema": sink.SCHEMA_VERSION,
            "label": "healthz",
            "ts": round(time.time(), 3),
            "remotes": remotes,
            "cycles": cycles,
        }


# ------------------------------------------------------- process default
_default: LiveTelemetryServer | None = None
_env_resolved = False
_state_lock = threading.Lock()


def default_server() -> "LiveTelemetryServer | None":
    """The process-default server, lazily started from ``CRDT_OBS_HTTP``
    (resolved ONCE per process — a server is a bound socket, not a
    re-readable path), else None."""
    global _default, _env_resolved
    if _env_resolved:
        return _default
    with _state_lock:
        if _env_resolved:
            return _default
        import os

        raw = os.environ.get(ENV_VAR, "")
        _env_resolved = True
        if raw:
            host, _, port_s = raw.rpartition(":")
            try:
                srv = LiveTelemetryServer(
                    port=int(port_s), host=host or "127.0.0.1"
                )
                srv.start()
                _default = srv
            except (ValueError, OSError):
                logger.warning(
                    "CRDT_OBS_HTTP=%r: could not start the telemetry "
                    "server; live endpoint disabled", raw,
                )
        return _default


def shutdown() -> None:
    """Stop the default server (if any) — FINAL for this process: env
    resolution stays latched, so the next replication sample does not
    silently rebind the port the embedder just closed."""
    global _default, _env_resolved
    with _state_lock:
        if _default is not None:
            _default.stop()
        _default = None
        _env_resolved = True


def _reset() -> None:
    """Test seam: shutdown AND re-arm env resolution, so a test can
    exercise the ``CRDT_OBS_HTTP`` lazy start from a clean slate."""
    global _default, _env_resolved
    with _state_lock:
        if _default is not None:
            _default.stop()
        _default = None
        _env_resolved = False


def publish(status: dict) -> None:
    """Feed one replication status to the default server.  The hook
    ``Core._sample_replication`` calls — a single global check when no
    server is configured, a lock-guarded dict store when one is."""
    srv = default_server()
    if srv is not None:
        srv.publish_health(status)
