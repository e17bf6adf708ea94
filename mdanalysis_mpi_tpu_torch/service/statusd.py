"""Live status endpoint: ``/metrics``, ``/healthz``, ``/status``
(docs/OBSERVABILITY.md "Fleet federation").

A tiny stdlib ``http.server`` tier an operator (or a Prometheus
scraper) can hit while a controller or scheduler is serving:

- ``/metrics`` — Prometheus text exposition of the process's unified
  snapshot (for a fleet controller: the MERGED fleet document — host
  counters summed, host gauges labeled);
- ``/healthz`` — liveness JSON, HTTP 200 while healthy / 503 once
  wedged or shut down;
- ``/status`` — the operational JSON an operator greps logs for
  today: queue depth, leases, breaker states, hosts alive, epoch,
  quarantine;
- ``/usage`` — the tenant-facing usage document (obs/usage.py
  ``usage_doc``): per-(tenant, class) monotone meters, per-class
  rollups, and the top-N tenants by dispatch seconds.

A standalone :class:`~mdanalysis_mpi_tpu_torch.service.scheduler.
Scheduler` opts in via ``serve_status()`` / the batch CLI's
``--status-port``.  The server binds a loopback address only
(``127.0.0.1`` by default; any other ``bind_host`` is refused).
Requests are counted (``mdtpu_status_requests_total{route=}``).

``python -m mdanalysis_mpi_tpu_torch status [--json] [addr]`` is the
one-shot fetch side (this module imports only the standard library and
``obs``).  A fleet workdir as the target needs the fleet controller,
which the port does not have yet (ROADMAP A10, the fleet slice).
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mdanalysis_mpi_tpu_torch.obs import metrics as _metrics

#: The addresses :class:`StatusServer` may bind: loopback only.
LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1")

#: The routes the request counter labels by name; anything else
#: counts as ``route="other"`` (a 404).
ROUTES = ("/status", "/metrics", "/healthz", "/usage")


class StatusServer:
    """One daemon HTTP thread serving the three routes off caller
    snapshots.  ``status_fn`` → dict, ``metrics_fn`` → Prometheus
    text, ``health_fn`` → dict with an ``"ok"`` bool (omitted: always
    healthy).  Port 0 binds an ephemeral port; read it back from
    :attr:`address`."""

    def __init__(self, status_fn, metrics_fn=None, health_fn=None,
                 usage_fn=None, bind_host: str = "127.0.0.1",
                 port: int = 0):
        from mdanalysis_mpi_tpu_torch.obs import usage as _usage

        if bind_host not in LOOPBACK_HOSTS:
            raise ValueError(
                f"StatusServer binds a loopback address only "
                f"({', '.join(LOOPBACK_HOSTS)}), not {bind_host!r}")
        self._status_fn = status_fn
        self._metrics_fn = metrics_fn or (
            lambda: _metrics.to_prometheus(_metrics.unified_snapshot()))
        self._health_fn = health_fn or (lambda: {"ok": True})
        self._usage_fn = usage_fn or (
            lambda: _usage.usage_doc(_metrics.unified_snapshot()))
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):     # quiet: obs, not stderr
                pass

            def do_GET(self):
                route = self.path.split("?", 1)[0]
                code, ctype, body = outer._respond(route)
                _metrics.METRICS.inc(
                    "mdtpu_status_requests_total",
                    route=route if route in ROUTES else "other")
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass              # client went away mid-response

        self._server = ThreadingHTTPServer((bind_host, port), _Handler)
        self._server.daemon_threads = True
        self.address = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="mdtpu-statusd")
        self._thread.start()

    def _respond(self, route: str) -> tuple[int, str, bytes]:
        try:
            if route == "/metrics":
                return (200, "text/plain; version=0.0.4",
                        self._metrics_fn().encode())
            if route == "/healthz":
                health = self._health_fn()
                code = 200 if health.get("ok") else 503
                return (code, "application/json",
                        json.dumps(health).encode())
            if route == "/status":
                return (200, "application/json",
                        json.dumps(self._status_fn(),
                                   default=str).encode())
            if route == "/usage":
                return (200, "application/json",
                        json.dumps(self._usage_fn(),
                                   default=str).encode())
            return (404, "application/json",
                    json.dumps({"error": f"no route {route!r}",
                                "routes": list(ROUTES)}).encode())
        except Exception as exc:   # a snapshot bug must not kill the
            #                        serving thread — disclose it
            return (500, "application/json",
                    json.dumps({"error": f"{type(exc).__name__}: "
                                         f"{exc}"}).encode())

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the one-shot `status` CLI
# ---------------------------------------------------------------------------

def _resolve_target(target: str) -> tuple[str, int]:
    """``host:port`` / bare port / a fleet workdir holding
    ``controller.addr`` (whose ``status_port`` the controller
    published beside its command address)."""
    if os.path.isdir(target):
        try:
            from mdanalysis_mpi_tpu_torch.service import fleet as _fleet
        except ImportError as exc:
            raise NotImplementedError(
                f"{target!r} is a fleet workdir: reading its "
                "controller.addr needs service/fleet.py, which the "
                "port does not have yet (ROADMAP A10, the fleet "
                "slice); pass host:port or a bare port") from exc

        info = _fleet._read_addr_file(target)
        if info is None:
            raise SystemExit(
                f"{target!r} holds no readable controller.addr — is a "
                "fleet controller running against this workdir?")
        port = info.get("status_port")
        if not port:
            raise SystemExit(
                f"the controller at {target!r} published no status "
                "port (status endpoint disabled)")
        return info.get("host", "127.0.0.1"), int(port)
    host, sep, port = target.rpartition(":")
    if sep and port.isdigit():
        return host or "127.0.0.1", int(port)
    if target.isdigit():
        return "127.0.0.1", int(target)
    raise SystemExit(
        f"cannot resolve {target!r}: pass host:port, a bare port, or "
        "a fleet workdir containing controller.addr")


def fetch_status(target: str, route: str = "/status",
                 timeout: float = 5.0):
    """GET one route from a running controller/scheduler endpoint.
    Returns parsed JSON for the JSON routes, text for ``/metrics``."""
    import urllib.request

    host, port = _resolve_target(target)
    with urllib.request.urlopen(f"http://{host}:{port}{route}",
                                timeout=timeout) as resp:
        body = resp.read().decode()
    return body if route == "/metrics" else json.loads(body)


def _fmt_scalar(v) -> str:
    return json.dumps(v) if isinstance(v, str) else str(v)


def _print_human(doc: dict) -> None:
    role = doc.get("role", "?")
    print(f"{role} status")
    for key in sorted(doc):
        val = doc[key]
        if isinstance(val, (dict, list)):
            continue
        print(f"  {key:<28} {_fmt_scalar(val)}")
    hosts = doc.get("hosts")
    if isinstance(hosts, dict) and hosts:
        print("  hosts:")
        for hid in sorted(hosts):
            h = hosts[hid]
            flags = " ".join(f"{k}={_fmt_scalar(v)}"
                             for k, v in sorted(h.items()))
            print(f"    {hid:<12} {flags}")
    leases = doc.get("leases")
    if isinstance(leases, list) and leases:
        print("  leases:")
        for lease in leases:
            flags = " ".join(f"{k}={_fmt_scalar(v)}"
                             for k, v in sorted(lease.items()))
            print(f"    {flags}")
    breakers = doc.get("breakers")
    if isinstance(breakers, dict) and breakers:
        print("  breakers:")
        for name in sorted(breakers):
            print(f"    {name:<12} {breakers[name]}")
    quarantined = doc.get("quarantined")
    if quarantined:
        print(f"  quarantined: {', '.join(map(str, quarantined))}")
    alerts = doc.get("alerts")
    if isinstance(alerts, dict) and alerts.get("firing"):
        print(f"  alerts firing: {len(alerts['firing'])} "
              "(see --alerts)")


def _fmt_at(v) -> str:
    return "-" if v is None else f"{float(v):.3f}"


def _print_alerts(doc: dict) -> None:
    """The ``--alerts`` view: the firing table plus the recent
    firing/resolved transition history from the ``/status``
    ``alerts`` block (obs/alerts.py)."""
    alerts = doc.get("alerts")
    if not isinstance(alerts, dict):
        print("no alerts block (alerting disabled on this endpoint)")
        return
    firing = alerts.get("firing") or []
    print(f"{len(firing)} alert(s) firing "
          f"({len(alerts.get('rules') or [])} rule(s) registered)")
    if firing:
        print(f"  {'rule':<24} {'series':<28} {'value':>10} "
              f"{'since':>10}")
        for a in firing:
            print(f"  {a.get('rule', '?'):<24} "
                  f"{a.get('series') or '-':<28} "
                  f"{_fmt_at(a.get('value')):>10} "
                  f"{_fmt_at(a.get('since')):>10}")
    recent = alerts.get("recent") or []
    if recent:
        print("  recent transitions:")
        for tr in recent[-16:]:
            print(f"    {_fmt_at(tr.get('at')):>10}  "
                  f"{tr.get('rule', '?'):<24} "
                  f"{tr.get('state', '?'):<9} "
                  f"{tr.get('series') or '-':<28} "
                  f"value={_fmt_at(tr.get('value'))}")


def status_main(argv=None) -> int:
    """Entry point of the ``status`` subcommand: one-shot fetch of
    ``/status`` from a running controller/scheduler."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch status",
        description="fetch /status from a running fleet controller "
                    "or scheduler status endpoint "
                    "(docs/OBSERVABILITY.md)")
    p.add_argument("target", nargs="?", default=".",
                   help="host:port, bare port, or a fleet workdir "
                        "holding controller.addr (default: cwd)")
    p.add_argument("--json", action="store_true",
                   help="print the raw /status JSON instead of the "
                        "human-readable table")
    p.add_argument("--alerts", action="store_true",
                   help="render the firing/resolved alert table from "
                        "the /status alerts block (obs/alerts.py, "
                        "docs/OBSERVABILITY.md)")
    p.add_argument("--timeout", type=float, default=5.0)
    ns = p.parse_args(argv)
    try:
        doc = fetch_status(ns.target, timeout=ns.timeout)
    except OSError as exc:
        print(json.dumps({"error": f"{type(exc).__name__}: {exc}",
                          "target": ns.target}))
        return 1
    if ns.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    elif ns.alerts:
        _print_alerts(doc)
    else:
        _print_human(doc)
    return 0


def usage_main(argv=None) -> int:
    """Entry point of the ``usage`` subcommand: one-shot fetch of
    ``/usage`` from a running controller/scheduler — the per-tenant
    meter table, per-class rollups, and
    the top-N tenants by dispatch seconds."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mdanalysis_mpi_tpu_torch usage",
        description="fetch /usage (per-tenant usage meters) from a "
                    "running fleet controller or scheduler status "
                    "endpoint (docs/OBSERVABILITY.md)")
    p.add_argument("target", nargs="?", default=".",
                   help="host:port, bare port, or a fleet workdir "
                        "holding controller.addr (default: cwd)")
    p.add_argument("--json", action="store_true",
                   help="print the raw /usage JSON instead of the "
                        "human-readable table")
    p.add_argument("--top", type=int, default=None, metavar="N",
                   help="limit the ranked tenant table to the top N "
                        "by dispatch seconds")
    p.add_argument("--timeout", type=float, default=5.0)
    ns = p.parse_args(argv)
    try:
        doc = fetch_status(ns.target, route="/usage",
                           timeout=ns.timeout)
    except OSError as exc:
        print(json.dumps({"error": f"{type(exc).__name__}: {exc}",
                          "target": ns.target}))
        return 1
    if ns.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    else:
        from mdanalysis_mpi_tpu_torch.obs import usage as _usage

        print(_usage.render_usage(doc, top=ns.top))
    return 0
