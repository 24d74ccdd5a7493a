"""Minimal stdlib HTTP exposition of the metrics registry, as
``apex_tpu/obs/exposition.py``: ``http.server`` on a background thread,
three endpoints, no dependency, nothing on the step path (a scrape reads
the registry's RESOLVED state under its own lock, never a device value,
the rule the incident snapshot follows):

- ``/metrics``: the primary registry's Prometheus text exposition;
- ``/fleet``: the bucket-union merge of every attached registry
  (:func:`apex_tpu_torch.obs.fleet.merge_registries`: counters sum,
  histograms union), with the per-replica gauges of
  :func:`~apex_tpu_torch.obs.fleet.gauge_table` appended as
  ``# gauge-table`` comment lines;
- ``/healthz``: liveness (``ok``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from apex_tpu_torch.obs import fleet
from apex_tpu_torch.obs import metrics as obs_metrics

__all__ = ["MetricsServer"]


class MetricsServer:
    """Serve one registry (and optionally a fleet of them) over HTTP.

    >>> srv = MetricsServer(registry=eng.metrics)
    >>> host, port = srv.start()          # port=0 picks a free one
    >>> ...                               # GET /metrics, /fleet
    >>> srv.stop()
    """

    def __init__(self,
                 registry: Optional[obs_metrics.Registry] = None,
                 fleet_registries: Optional[Dict[str, obs_metrics.Registry]]
                 = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry if registry is not None \
            else obs_metrics.DEFAULT
        #: ``{label: registry}`` of the fleet view (``/fleet``); the
        #: primary registry is NOT implicitly included — the router
        #: passes its replicas' registries explicitly
        self.fleet_registries = dict(fleet_registries or {})
        self._host, self._port = host, port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- payloads ------------------------------------------------------

    def metrics_text(self) -> str:
        return self.registry.to_prometheus()

    def fleet_text(self) -> str:
        regs = list(self.fleet_registries.values())
        if not regs:
            return "# no fleet registries attached\n"
        merged = fleet.merge_registries(regs)
        text = merged.to_prometheus()
        table = fleet.gauge_table(regs,
                                  list(self.fleet_registries.keys()))
        lines = [f"# gauge-table {json.dumps({name: vals})}"
                 for name, vals in table.items()]
        return text + "".join(line + "\n" for line in lines)

    # -- the server ----------------------------------------------------

    def start(self) -> Tuple[str, int]:
        """Bind and serve on a daemon thread; returns ``(host,
        port)`` (the OS-assigned port when constructed with 0)."""
        if self._httpd is not None:
            raise RuntimeError("MetricsServer already started")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                      # noqa: N802
                if self.path.split("?")[0] == "/metrics":
                    body, ctype = outer.metrics_text(), \
                        "text/plain; version=0.0.4"
                elif self.path.split("?")[0] == "/fleet":
                    body, ctype = outer.fleet_text(), \
                        "text/plain; version=0.0.4"
                elif self.path.split("?")[0] == "/healthz":
                    body, ctype = "ok\n", "text/plain"
                else:
                    self.send_error(404)
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):              # quiet server
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="apex-tpu-torch-metrics-http")
        self._thread.start()
        return self._httpd.server_address[0], \
            self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=2.0)
                self._thread = None
