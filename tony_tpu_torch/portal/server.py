"""History web portal: the reference's Play-framework history server,
re-imagined as a dependency-free stdlib HTTP server.

Reference model: ``tony-portal`` — routes (``conf/routes:1-5``):
jobs index ``/``, per-job config ``/config/:jobId``, events
``/jobs/:jobId``, logs ``/logs/:jobId``; Guava caches warming parsed
metadata/config/events/logs (``cache/CacheWrapper.java:82-126``); background
``HistoryFileMover`` (intermediate → finished/yyyy/MM/dd, every 5 min) and
``HistoryFilePurger`` (retention deletes) singletons (``Module.java:14-22``).

Every view is served as HTML (human) or JSON (``?format=json`` — the
machine-readable surface the reference lacks). Log links only resolve paths
recorded in the job's own TASK_FINISHED events, never caller-supplied ones.
"""

from __future__ import annotations

import html
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from tony_tpu_torch import constants
from tony_tpu_torch.events import history

log = logging.getLogger(__name__)

_CACHE_TTL_S = 30.0


class _Cache:
    """TTL cache per (kind, job) — the CacheWrapper analogue. Finished jobs
    never change, so entries for terminal jobs are kept until evicted."""

    def __init__(self, ttl_s: float = _CACHE_TTL_S, max_entries: int = 256):
        self._data: Dict[Tuple[str, str], Tuple[float, Any]] = {}
        self._ttl = ttl_s
        self._max = max_entries
        self._lock = threading.Lock()

    def get(self, kind: str, key: str):
        with self._lock:
            hit = self._data.get((kind, key))
        if hit and (time.monotonic() - hit[0]) < self._ttl:
            return hit[1]
        return None

    def put(self, kind: str, key: str, value) -> None:
        with self._lock:
            if len(self._data) >= self._max:
                oldest = min(self._data, key=lambda k: self._data[k][0])
                del self._data[oldest]
            self._data[(kind, key)] = (time.monotonic(), value)


class PortalServer:
    """Serves the four history views + JSON API; owns mover/purger threads."""

    def __init__(self, history_root: str, port: int = 0,
                 host: str = "127.0.0.1", mover_interval_s: float = 300.0,
                 purger_interval_s: float = 3600.0,
                 retention_days: int = 30, token: str = "",
                 tls_cert: str = "", tls_key: str = "",
                 fleet_dir: str = ""):
        # Optional bearer auth: with a token set, every request must carry
        # "Authorization: Bearer <token>" or gets 401. The reference portal
        # ran behind keytab-login Play infra (hadoop/Requirements.java:
        # 24-70); a shared token is the TPU-native minimum for a portal
        # that binds beyond localhost. TONY_PORTAL_TOKEN in `tony-tpu
        # portal` / module main.
        self.token = token
        self.history_root = history_root
        # Fleet scheduler view (/fleet): explicit dir, else discovered —
        # a fleet daemon's history root lives INSIDE its fleet dir, so
        # the parent holding a fleet journal is the fleet.
        if not fleet_dir:
            parent = os.path.dirname(os.path.abspath(history_root))
            if os.path.exists(os.path.join(
                    parent, constants.FLEET_JOURNAL_FILE)):
                fleet_dir = parent
        self.fleet_dir = fleet_dir
        self.cache = _Cache()
        self._mover = history.HistoryFileMover(history_root)
        self._purger = history.HistoryFilePurger(history_root, retention_days)
        self._mover_interval = mover_interval_s
        self._purger_interval = purger_interval_s
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        portal = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet; use logging
                log.debug("portal: " + fmt, *args)

            def do_GET(self):  # noqa: N802
                portal._route(self)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        if tls_cert:
            # HTTPS opt-in (same cert pair as the RPC plane): without it a
            # bearer token rides plaintext HTTP, which is only acceptable
            # on localhost. do_handshake_on_connect=False defers the
            # handshake from accept() (which runs in the single
            # serve_forever thread — a stalled client there would hang the
            # whole portal) to the first read, inside the per-request
            # handler thread; Handler.timeout bounds that thread too.
            from tony_tpu_torch.rpc.wire import server_tls_context
            Handler.timeout = 60
            self.httpd.socket = server_tls_context(
                tls_cert, tls_key).wrap_socket(
                    self.httpd.socket, server_side=True,
                    do_handshake_on_connect=False)
        self.scheme = "https" if tls_cert else "http"
        self.port = self.httpd.server_address[1]

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        t = threading.Thread(target=self.httpd.serve_forever,
                             name="tony-portal", daemon=True)
        t.start()
        self._threads.append(t)
        for name, fn, interval in (
                ("tony-history-mover", self._mover.move_once,
                 self._mover_interval),
                ("tony-history-purger", self._purger.purge_once,
                 self._purger_interval)):
            th = threading.Thread(target=self._periodic, name=name,
                                  args=(fn, interval), daemon=True)
            th.start()
            self._threads.append(th)

    def _periodic(self, fn, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                fn()
            except Exception as e:  # noqa: BLE001
                log.warning("%s failed: %s", fn.__name__, e)

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()

    @property
    def url(self) -> str:
        return f"{self.scheme}://{self.httpd.server_address[0]}:{self.port}"

    # -- routing ---------------------------------------------------------
    def _route(self, req: BaseHTTPRequestHandler) -> None:
        if self.token:
            import hmac as hmaclib

            # Compare as bytes: compare_digest on str raises TypeError for
            # non-ASCII (headers arrive latin-1-decoded), which would kill
            # the request instead of 401ing; constant-time so the token
            # can't be recovered from 401 latencies.
            auth = req.headers.get("Authorization", "").encode(
                "latin-1", "replace")
            want = f"Bearer {self.token}".encode("latin-1", "replace")
            if not hmaclib.compare_digest(auth, want):
                return self._send(req, 401, "text/plain",
                                  b"unauthorized (bearer token required)")
        parsed = urlparse(req.path)
        parts = [p for p in parsed.path.split("/") if p]
        query = parse_qs(parsed.query)
        as_json = query.get("format", [""])[0] == "json"
        try:
            if not parts:
                return self._jobs_index(req, as_json)
            if parts == ["metrics"]:
                # Bare /metrics: Prometheus text exposition across every
                # LIVE job — the scrape endpoint (per-job HTML stays at
                # /metrics/<job>).
                return self._prom_view(req)
            if parts == ["fleet"]:
                # Fleet scheduler row (tony_tpu_torch/fleet/): live from a
                # running daemon's RPC, exported artifacts otherwise —
                # never the TTL cache, the fleet is always live.
                return self._fleet_view(req, as_json)
            if parts == ["alerts"]:
                # SLO/alert rollup (tony_tpu_torch/alerts/): fleet-scope rule
                # state + every job's journaled alert fold.
                return self._alerts_view(req, as_json)
            if parts == ["whatif"]:
                # Fleet time machine (fleet/simulator.py): replay the
                # recorded journal under counterfactual quotas/pool/
                # priorities passed as query params.
                return self._whatif_view(req, query, as_json)
            view, *rest = parts
            if view in ("config", "jobs", "logs", "logfile",
                        "profiles", "profile", "metrics", "trace",
                        "diagnose") and rest:
                job_id = rest[0]
                if view == "config":
                    return self._config_view(req, job_id, as_json)
                if view == "jobs":
                    return self._events_view(req, job_id, as_json)
                if view == "logs":
                    return self._logs_view(req, job_id, as_json)
                if view == "logfile" and len(rest) >= 2:
                    return self._logfile_view(req, job_id, int(rest[1]),
                                              query)
                if view in ("profiles", "profile"):
                    # /profile/<app> (singular) is the documented spelling
                    # for on-demand captures; both list the same dir.
                    return self._profiles_view(req, job_id, as_json)
                if view == "metrics":
                    return self._metrics_view(req, job_id, as_json)
                if view == "trace":
                    return self._trace_view(req, job_id, as_json)
                if view == "diagnose":
                    return self._diagnose_view(req, job_id, as_json)
            self._send(req, 404, "text/plain", b"not found")
        except Exception as e:  # noqa: BLE001
            log.exception("portal error for %s", req.path)
            self._send(req, 500, "text/plain",
                       f"internal error: {e}".encode())

    # -- views -----------------------------------------------------------
    def _jobs_index(self, req, as_json: bool) -> None:
        rows = history.list_jobs(self.history_root)
        if as_json:
            payload = [dict(app_id=r.app_id, status=r.status, user=r.user,
                            started_ms=r.started_ms) for r in rows]
            return self._send_json(req, payload)
        body = ["<h1>tony-tpu jobs</h1>"]
        if self.fleet_dir:
            body.append("<p><a href='/fleet'>fleet scheduler</a> — "
                        "queue, tenants, grants · "
                        "<a href='/whatif'>whatif</a> — counterfactual "
                        "replay</p>")
        body.append("<p><a href='/alerts'>alerts</a> — SLO rule "
                    "state, fleet + per job</p>")
        body += ["<table border=1 cellpadding=4>",
                 "<tr><th>job</th><th>status</th><th>user</th>"
                 "<th>started</th><th></th></tr>"]
        for r in rows:
            a = html.escape(r.app_id)
            body.append(
                f"<tr><td>{a}</td><td>{html.escape(r.status)}</td>"
                f"<td>{html.escape(r.user)}</td><td>{r.started_iso}</td>"
                f"<td><a href='/jobs/{a}'>events</a> "
                f"<a href='/config/{a}'>config</a> "
                f"<a href='/logs/{a}'>logs</a> "
                f"<a href='/profiles/{a}'>profiles</a> "
                f"<a href='/metrics/{a}'>metrics</a> "
                f"<a href='/trace/{a}'>trace</a> "
                f"<a href='/diagnose/{a}'>diagnose</a></td></tr>")
        body.append("</table>")
        self._send_html(req, "".join(body))

    def _job_dir(self, job_id: str) -> Optional[str]:
        return history.list_job_dirs(self.history_root).get(job_id)

    def _fleet_client(self):
        """FleetClient for a RUNNING daemon (addr file present), else
        None. The live-object bypass for the fleet views: the exported
        fleet.status.json/fleet.prom only refresh on the daemon's
        export cadence — the same staleness the per-job views fixed by
        skipping the TTL cache for in-progress jobs — so a live daemon
        is asked directly and the files stay the dead-daemon fallback."""
        if not self.fleet_dir or not os.path.exists(
                os.path.join(self.fleet_dir, constants.FLEET_ADDR_FILE)):
            return None
        from tony_tpu_torch.fleet.client import FleetClient
        return FleetClient(self.fleet_dir)

    def _fleet_snapshot(self) -> Tuple[Optional[dict], Optional[str]]:
        """(status snapshot, prom text): live from the daemon's RPC
        when it is up, else the exported artifacts."""
        client = self._fleet_client()
        if client is not None:
            try:
                return client.status(), client.prom()
            except Exception as e:  # noqa: BLE001 — stale addr, dying daemon
                log.debug("fleet live bypass failed (%s); serving the "
                          "exported artifacts", e)
            finally:
                client.close()
        snap = prom = None
        try:
            with open(os.path.join(self.fleet_dir,
                                   constants.FLEET_STATUS_FILE),
                      encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, ValueError):
            pass
        try:
            with open(os.path.join(self.fleet_dir,
                                   constants.FLEET_PROM_FILE),
                      encoding="utf-8") as f:
                prom = f.read()
        except OSError:
            pass
        return snap, prom

    def _fleet_view(self, req, as_json: bool) -> None:
        """Scheduler snapshot + tony_fleet_* families: live from a
        running daemon's RPC (see _fleet_client), falling back to the
        atomically replaced artifacts when the daemon is down."""
        if not self.fleet_dir:
            return self._send(req, 404, "text/plain",
                              b"no fleet dir configured or discovered")
        snap, prom = self._fleet_snapshot()
        if snap is None:
            return self._send(req, 404, "text/plain",
                              b"no fleet status snapshot yet")
        if as_json:
            return self._send_json(req, snap)
        pool = snap.get("pool") or {}
        qw = snap.get("queue_wait") or {}
        body = [f"<h1>fleet — {html.escape(str(snap.get('fleet_dir')))}"
                f"</h1>",
                f"<p>generation {snap.get('generation', '?')} — hosts "
                f"{pool.get('used', '?')}/{pool.get('total', '?')} used "
                f"({pool.get('free', '?')} free), queue depth "
                f"{snap.get('queue_depth', '?')}, wait p50 "
                f"{qw.get('p50_s', 0)}s / p99 {qw.get('p99_s', 0)}s — "
                f"<a href='/whatif'>whatif</a> (counterfactual "
                f"replay)</p>"]
        # Fleet incident verdict (fleet/diagnose.py): the daemon
        # refreshes fleet.incident.json every export; torn/absent
        # degrades to no banner (same posture as incident.json).
        incident = None
        try:
            with open(os.path.join(self.fleet_dir,
                                   constants.FLEET_INCIDENT_FILE),
                      encoding="utf-8") as f:
                incident = json.load(f)
        except (OSError, ValueError):
            pass
        if isinstance(incident, dict) and incident.get("verdict"):
            v = incident["verdict"]
            body.append(
                f"<p><b>verdict: "
                f"{html.escape(str(v.get('category', '?')))}</b> — "
                f"{html.escape(str(v.get('summary', '')))}<br>"
                f"advice: {html.escape(str(v.get('advice', '')))}</p>")
        # Firing-alert banner (tony_tpu_torch/alerts/): quiet when nothing
        # fires; /alerts has the full per-rule table.
        fal = snap.get("alerts") or {}
        if fal.get("degraded") or fal.get("firing"):
            parts = []
            if fal.get("degraded"):
                parts.append("evaluation DEGRADED")
            for r in fal.get("firing") or []:
                parts.append(
                    f"{html.escape(str(r.get('rule', '?')))} "
                    f"[{html.escape(str(r.get('severity', '?')))}]")
            body.append("<p><b>alerts</b> — " + "; ".join(parts)
                        + " (<a href='/alerts'>details</a>)</p>")
        # Host-health cordon banner (fleet/health.py): quiet when the
        # fleet is clean — operators should only see it on an incident.
        health = snap.get("health") or {}
        if health.get("cordoned") or health.get("sick_slices"):
            parts = []
            if health.get("cordoned"):
                parts.append("cordoned hosts: " + html.escape(
                    ", ".join(str(h) for h in health["cordoned"])))
            if health.get("sick_slices"):
                parts.append("sick slices: " + html.escape(
                    ", ".join(str(i) for i in health["sick_slices"])))
            body.append("<p><b>host health</b> — " + "; ".join(parts)
                        + " (see `tony-tpu fleet health`)</p>")
        # Per-tenant goodput ledger table (fleet/ledger.py rollup).
        ledger = snap.get("ledger") or {}
        tenants = snap.get("tenants") or {}
        tenant_led = ledger.get("tenants") or {}
        if tenants or tenant_led:
            body.append("<h2>tenants</h2>"
                        "<table border=1 cellpadding=4><tr>"
                        "<th>tenant</th><th>hosts used/quota</th>"
                        "<th>goodput</th><th>train chip-s</th>"
                        "<th>held chip-s</th><th>queued chip-s lost"
                        "</th><th>warm starts</th></tr>")
            for t in sorted(set(tenants) | set(tenant_led)):
                row = tenants.get(t) or {}
                led = tenant_led.get(t) or {}
                gp = led.get("goodput_fraction")
                warm = led.get("warm_start_fraction")
                phase_chip = led.get("phase_chip_s") or {}
                body.append(
                    f"<tr><td>{html.escape(t)}</td>"
                    f"<td>{row.get('used', 0)}/"
                    f"{row.get('quota') or '∞'}</td>"
                    f"<td>{(f'{float(gp):.1%}' if gp is not None else '—')}"
                    f"</td>"
                    f"<td>{phase_chip.get('train', 0)}</td>"
                    f"<td>{led.get('held_chip_s', 0)}</td>"
                    f"<td>{led.get('lost_preempted_chip_s', 0)}</td>"
                    f"<td>{(f'{float(warm):.0%}' if warm is not None else '—')}"
                    f"</td></tr>")
            body.append("</table>")
        body.append("<h2>jobs</h2>"
                    "<table border=1 cellpadding=4><tr><th>job</th>"
                    "<th>tenant</th><th>pri</th><th>state</th>"
                    "<th>hosts</th><th>wait</th><th>app / held</th>"
                    "</tr>")
        for row in snap.get("jobs", []):
            app = str(row.get("app_id") or "")
            app_cell = (f"<a href='/jobs/{html.escape(app)}'>"
                        f"{html.escape(app)}</a>") if app else \
                html.escape(str(row.get("held") or row.get("denial")
                                or ""))
            wait = row.get("wait_s")
            body.append(
                f"<tr><td>{html.escape(str(row.get('job')))}</td>"
                f"<td>{html.escape(str(row.get('tenant')))}</td>"
                f"<td>{row.get('priority', 0)}</td>"
                f"<td>{html.escape(str(row.get('state')))}</td>"
                f"<td>{row.get('hosts', 0)}/"
                f"{row.get('hosts_requested', '?')}</td>"
                f"<td>{(f'{wait:.1f}s' if wait is not None else '')}</td>"
                f"<td>{app_cell}</td></tr>")
        body.append("</table>")
        if prom:
            body.append("<h2>tony_fleet_* exposition</h2><pre>"
                        + html.escape(prom) + "</pre>")
        self._send_html(req, "".join(body))

    def _whatif_view(self, req, query: Dict[str, List[str]],
                     as_json: bool) -> None:
        """Counterfactual replay of the recorded fleet journal
        (fleet/simulator.py): ``/whatif?quota=tenant=4&pool=2x8&
        priority=job=10&set=k=v&sweep=k=a,b,c``. Always recomputed —
        the journal grows while the daemon lives, and each query is a
        different experiment; the 50-job scale this targets re-folds in
        well under a second (BENCH_WHATIF budget: 5 s)."""
        if not self.fleet_dir:
            return self._send(req, 404, "text/plain",
                              b"no fleet dir configured or discovered")
        from tony_tpu_torch.fleet import simulator as fsim

        try:
            report = fsim.whatif_from_dir(
                self.fleet_dir, sets=query.get("set"),
                quotas=query.get("quota"),
                pool=(query.get("pool") or [""])[0] or None,
                priorities=query.get("priority"),
                sweeps=query.get("sweep"))
        except ValueError as e:
            return self._send(req, 400, "text/plain",
                              f"whatif: {e}".encode())
        except Exception as e:  # noqa: BLE001 — view stays up
            return self._send(req, 404, "text/plain",
                              f"whatif unavailable: {e}".encode())
        if as_json:
            return self._send_json(req, report)
        body = [f"<h1>fleet whatif — "
                f"{html.escape(str(report.get('journal')))}</h1>",
                "<p><a href='/fleet'>fleet</a> — recorded state. "
                "Query params: <code>quota=tenant=N</code>, "
                "<code>pool=SxH</code>, <code>priority=job=P</code>, "
                "<code>set=key=value</code>, "
                "<code>sweep=key=a,b,c</code> (repeatable).</p>"]
        par = report.get("parity") or {}
        if par.get("ok"):
            body.append("<p><b>parity: OK</b> — the recorded sequence "
                        "reproduces bit-for-bit; counterfactuals are "
                        "trustworthy</p>")
        elif not par.get("supported"):
            body.append(f"<p><b>parity: skipped</b> — "
                        f"{html.escape(str(par.get('reason', '')))}</p>")
        else:
            gate = "grant/preempt gate holds" if par.get("gate_ok") \
                else "grant/preempt gate BROKEN"
            body.append(f"<p><b>parity: "
                        f"{html.escape(json.dumps(par.get('mismatch_counts')))}"
                        f"</b> — {gate}</p>")
        rec = (report.get("recorded") or {}).get("metrics") or {}
        base = (report.get("base") or {}).get("metrics") or {}
        cfs = report.get("counterfactuals") or []
        keys = [k for k in fsim._TABLE_KEYS if k in rec or k in base]
        body.append("<table border=1 cellpadding=4><tr><th>metric</th>"
                    "<th>recorded</th><th>sim-base</th>"
                    + "".join(f"<th>{html.escape(c['label'])}</th>"
                              for c in cfs) + "</tr>")
        for k in keys:
            cells = ""
            for c in cfs:
                entry = (c.get("diff") or {}).get(k) or {}
                v = entry.get("counterfactual",
                              (c.get("metrics") or {}).get(k))
                mark = ""
                if entry.get("improves") is True:
                    mark = " ✓"
                elif entry.get("improves") is False:
                    mark = " ✗"
                cells += f"<td>{html.escape(fsim._cell(v))}{mark}</td>"
            body.append(f"<tr><td>{html.escape(k)}</td>"
                        f"<td>{html.escape(fsim._cell(rec.get(k)))}</td>"
                        f"<td>{html.escape(fsim._cell(base.get(k)))}</td>"
                        + cells + "</tr>")
        body.append("</table>")
        for c in cfs:
            removed = c.get("holds_removed") or []
            if not removed:
                continue
            body.append(f"<h2>{html.escape(c['label'])} — holds "
                        f"removed</h2><ul>")
            for h in removed:
                blocking = ", ".join(h.get("was_blocking") or []) or "—"
                body.append(
                    f"<li>tenant <b>{html.escape(h['tenant'])}</b>: "
                    f"{h['removed_s']}s of "
                    f"{html.escape(h['hold'].replace('_s', ''))} "
                    f"(was blocking: {html.escape(blocking)})</li>")
            body.append("</ul>")
        self._send_html(req, "".join(body))

    def _job_alerts(self, job_id: str) -> Dict[str, str]:
        """Final journaled alert state per rule (REC_ALERT fold) for one
        job. Live jobs bypass the TTL cache — their journal grows
        between requests, the same staleness contract as _events;
        finished jobs keep the cache."""
        if not self._job_live(job_id):
            hit = self.cache.get("alerts", job_id)
            if hit is not None:
                return hit
        job_dir = self._job_dir(job_id)
        if job_dir is None:
            return {}
        path = os.path.join(job_dir, constants.JOURNAL_FILE)
        alerts: Dict[str, str] = {}
        if os.path.exists(path):
            from tony_tpu_torch.coordinator import journal as cjournal
            try:
                alerts = dict(cjournal.replay(path).alerts)
            except Exception as e:  # noqa: BLE001 — view stays up
                log.debug("alert replay failed for %s: %s", job_id, e)
        if not self._job_live(job_id):
            self.cache.put("alerts", job_id, alerts)
        return alerts

    def _alerts_view(self, req, as_json: bool) -> None:
        """The firing-state rollup: fleet-scope rules (live from the
        daemon's engine, or the REC_FLEET_ALERT fold of a dead one)
        plus every job's journaled alert state — the portal face of
        `tony-tpu alerts` / `tony-tpu fleet alerts`."""
        fleet: Optional[dict] = None
        if self.fleet_dir:
            client = self._fleet_client()
            if client is not None:
                try:
                    fleet = client.alerts()
                except Exception:  # noqa: BLE001 — fall back to replay
                    fleet = None
                finally:
                    client.close()
            if fleet is None:
                from tony_tpu_torch.fleet import journal as fjournal
                try:
                    st = fjournal.replay(os.path.join(
                        self.fleet_dir, constants.FLEET_JOURNAL_FILE))
                    fleet = {"scope": "fleet", "offline": True,
                             "alerts": [{"rule": r, "state": s}
                                        for r, s
                                        in sorted(st.alerts.items())]}
                except Exception as e:  # noqa: BLE001
                    log.debug("fleet alert replay failed: %s", e)
        jobs = {job_id: self._job_alerts(job_id)
                for job_id in sorted(
                    history.list_job_dirs(self.history_root))}
        jobs = {j: a for j, a in jobs.items() if a}
        if as_json:
            return self._send_json(req, {"fleet": fleet, "jobs": jobs})
        body = ["<h1>alerts</h1>"]
        if fleet is not None:
            body.append("<h2>fleet</h2>")
            if fleet.get("degraded"):
                body.append("<p><b>evaluation DEGRADED</b> — disabled "
                            "after a fault; restart the daemon to "
                            "re-arm</p>")
            if fleet.get("offline"):
                body.append("<p>(journal replay — no live daemon)</p>")
            rows = fleet.get("alerts") or []
            if rows:
                body.append("<table border=1 cellpadding=4><tr>"
                            "<th>rule</th><th>state</th><th>severity"
                            "</th><th>value</th><th>series</th></tr>")
                for r in rows:
                    state = str(r.get("state", "?"))
                    cell = f"<b>{html.escape(state)}</b>" \
                        if state == "firing" else html.escape(state)
                    v = r.get("value")
                    body.append(
                        f"<tr><td>{html.escape(str(r.get('rule')))}"
                        f"</td><td>{cell}</td>"
                        f"<td>{html.escape(str(r.get('severity', '')))}"
                        f"</td><td>{'' if v is None else f'{v:.4g}'}"
                        f"</td><td>{html.escape(str(r.get('series', '')))}"
                        f"</td></tr>")
                body.append("</table>")
            else:
                body.append("<p>no fleet alert transitions</p>")
        body.append("<h2>jobs</h2>")
        if not jobs:
            body.append("<p>no journaled alert transitions in any "
                        "job</p>")
        else:
            body.append("<table border=1 cellpadding=4><tr><th>job</th>"
                        "<th>rule</th><th>state</th></tr>")
            for job_id, alerts in jobs.items():
                a = html.escape(job_id)
                for rule, state in sorted(alerts.items()):
                    cell = f"<b>{html.escape(state)}</b>" \
                        if state == "firing" else html.escape(state)
                    body.append(
                        f"<tr><td><a href='/metrics/{a}'>{a}</a></td>"
                        f"<td>{html.escape(rule)}</td>"
                        f"<td>{cell}</td></tr>")
            body.append("</table>")
        self._send_html(req, "".join(body))

    def _config_view(self, req, job_id: str, as_json: bool) -> None:
        conf = self.cache.get("config", job_id)
        if conf is None:
            job_dir = self._job_dir(job_id)
            if job_dir is None:
                return self._send(req, 404, "text/plain", b"unknown job")
            path = os.path.join(job_dir, constants.FINAL_CONFIG_FILE)
            if not os.path.exists(path):
                return self._send(req, 404, "text/plain",
                                  b"no frozen config for job")
            with open(path, encoding="utf-8") as f:
                conf = json.load(f)
            self.cache.put("config", job_id, conf)
        if as_json:
            return self._send_json(req, conf)
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in sorted(conf.items()))
        self._send_html(
            req, f"<h1>config — {html.escape(job_id)}</h1>"
                 f"<table border=1 cellpadding=4>"
                 f"<tr><th>key</th><th>value</th></tr>{rows}</table>")

    def _job_live(self, job_id: str) -> bool:
        """Still-running job: its dir holds only an .inprogress stream (no
        finalized history file yet)."""
        job_dir = self._job_dir(job_id)
        return job_dir is not None and \
            history.find_history_file(job_dir) is None

    def _events(self, job_id: str):
        # Cache bypass for IN-PROGRESS jobs: their event stream grows
        # between requests, and the live views (events, metrics,
        # liveness incidents) must never serve a snapshot up to
        # _CACHE_TTL_S stale. Finished jobs never change — they keep the
        # cache (the reference CacheWrapper behaviour).
        if self._job_live(job_id):
            return history.read_job_events(self.history_root, job_id)
        evs = self.cache.get("events", job_id)
        if evs is None:
            evs = history.read_job_events(self.history_root, job_id)
            if evs is not None:
                self.cache.put("events", job_id, evs)
        return evs

    def _events_view(self, req, job_id: str, as_json: bool) -> None:
        evs = self._events(job_id)
        if evs is None:
            return self._send(req, 404, "text/plain", b"unknown job")
        if as_json:
            return self._send_json(
                req, [dict(type=e.type, timestamp_ms=e.timestamp_ms,
                           payload=e.payload) for e in evs])
        rows = "".join(
            f"<tr><td>{e.timestamp_ms}</td><td>{html.escape(e.type)}</td>"
            f"<td><pre>{html.escape(json.dumps(e.payload, indent=1))}"
            f"</pre></td></tr>" for e in evs)
        self._send_html(
            req, f"<h1>events — {html.escape(job_id)}</h1>"
                 f"<table border=1 cellpadding=4><tr><th>ts</th><th>type"
                 f"</th><th>payload</th></tr>{rows}</table>")

    def _metrics_view(self, req, job_id: str, as_json: bool) -> None:
        """Per-task final metrics from TASK_FINISHED events: memory/HBM
        aggregates + the utilization signal (steps/s, duty cycle, MFU)
        derived by telemetry.step() — the operator's one-stop 'is this job
        actually using its chips' view (reference surfaced per-task GPU
        util via TaskMonitor, TaskMonitor.java:116-170)."""
        evs = self._events(job_id)
        if evs is None:
            return self._send(req, 404, "text/plain", b"unknown job")
        tasks = [(e.payload.get("task", "?"), e.payload.get("metrics", {}))
                 for e in evs if e.type == "TASK_FINISHED"]
        if as_json:
            return self._send_json(
                req, [dict(task=t, metrics=m) for t, m in tasks])
        cols = sorted({k for _, m in tasks for k in m})
        head = "".join(f"<th>{html.escape(c)}</th>" for c in cols)
        rows = "".join(
            "<tr><td>" + html.escape(t) + "</td>" + "".join(
                f"<td>{html.escape(self._fmt_metric(m.get(c)))}</td>"
                for c in cols) + "</tr>"
            for t, m in tasks)
        self._send_html(
            req, f"<h1>metrics — {html.escape(job_id)}</h1>"
                 + self._alert_banner(job_id)
                 + f"<table border=1 cellpadding=4><tr><th>task</th>"
                 f"{head}</tr>{rows}</table>"
                 + self._coord_section(job_id)
                 + self._liveness_incidents(evs))

    def _alert_banner(self, job_id: str) -> str:
        """Firing-alert banner for the per-job views: quiet unless the
        journal fold says a rule is firing right now (live job) or was
        left firing at death (evidence — see /diagnose)."""
        firing = sorted(r for r, s in self._job_alerts(job_id).items()
                        if s == "firing")
        if not firing:
            return ""
        return ("<p><b>alerts firing:</b> "
                + ", ".join(html.escape(r) for r in firing)
                + " (<a href='/alerts'>details</a>)</p>")

    def _coord_section(self, job_id: str) -> str:
        """Control-plane self-observation table for the metrics view:
        the coordinator's own tony_coord_*/tony_journal_* families out
        of the job's live exposition (coordinator/coordphases.py) — is
        the CONTROL PLANE keeping up, next to whether the tasks are."""
        job_dir = self._job_dir(job_id)
        if job_dir is None:
            return ""
        path = os.path.join(job_dir, constants.METRICS_PROM_FILE)
        try:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        except OSError:
            return ""
        rows = []
        for line in text.splitlines():
            if line.startswith("#"):
                continue
            if line.startswith(("tony_coord_", "tony_journal_records",
                                "tony_journal_bytes")):
                name, _, value = line.rpartition(" ")
                rows.append(f"<tr><td><code>{html.escape(name)}</code>"
                            f"</td><td>{html.escape(value)}</td></tr>")
        if not rows:
            return ""
        return ("<h2>control plane (coordinator self-observation)</h2>"
                "<table border=1 cellpadding=4><tr><th>series</th>"
                "<th>value</th></tr>" + "".join(rows) + "</table>")

    #: progress-liveness event types surfaced as incidents on the metrics
    #: view (coordinator/liveness.py verdicts).
    _LIVENESS_EVENTS = ("TASK_HUNG", "TASK_STRAGGLER",
                        "TASK_PROGRESS_UNINSTRUMENTED")

    def _liveness_incidents(self, evs) -> str:
        """Hang/straggler incident table for the metrics view: the 'why
        did this job restart / crawl' answer next to the utilization
        numbers (full payloads — including the stack-dump excerpt riding
        the hang-kill TASK_FINISHED — stay in the events view)."""
        incidents = [e for e in evs if e.type in self._LIVENESS_EVENTS]
        if not incidents:
            return ""
        rows = "".join(
            f"<tr><td>{e.timestamp_ms}</td>"
            f"<td>{html.escape(e.type)}</td>"
            f"<td>{html.escape(str(e.payload.get('task', '?')))}</td>"
            f"<td><pre>{html.escape(json.dumps({k: v for k, v in e.payload.items() if k not in ('task', 'session_id')}, indent=1))}"
            f"</pre></td></tr>" for e in incidents)
        return (f"<h2>liveness incidents</h2>"
                f"<table border=1 cellpadding=4><tr><th>ts</th><th>type"
                f"</th><th>task</th><th>detail</th></tr>{rows}</table>")

    @staticmethod
    def _fmt_metric(v) -> str:
        if v is None:
            return ""
        if isinstance(v, float):
            return f"{v:,.4g}"
        return str(v)

    def _prom_view(self, req) -> None:
        """Prometheus scrape endpoint: concatenate the exposition files
        each live job's coordinator keeps fresh in its job dir
        (metrics.prom, tony.metrics.export-interval-s cadence), merged by
        metric family so HELP/TYPE lines stay unique and grouped. Never
        cached — a scrape must see the current write."""
        inter = os.path.join(self.history_root,
                             constants.HISTORY_INTERMEDIATE)
        families: Dict[str, Dict[str, List[str]]] = {}
        order: List[str] = []
        if os.path.isdir(inter):
            for app in sorted(os.listdir(inter)):
                path = os.path.join(inter, app, constants.METRICS_PROM_FILE)
                try:
                    with open(path, encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    continue
                fam = None
                for line in text.splitlines():
                    if line.startswith("# "):
                        parts = line.split(None, 3)
                        name = parts[2] if len(parts) > 2 else ""
                        fam = families.setdefault(
                            name, {"meta": [], "samples": []})
                        if name not in order:
                            order.append(name)
                        if line not in fam["meta"]:
                            fam["meta"].append(line)
                    elif line.strip() and fam is not None:
                        fam["samples"].append(line)
        lines: List[str] = []
        for name in order:
            lines.extend(families[name]["meta"])
            lines.extend(families[name]["samples"])
        body = ("\n".join(lines) + "\n") if lines \
            else "# no live jobs exporting metrics\n"
        self._send(req, 200,
                   "text/plain; version=0.0.4; charset=utf-8",
                   body.encode())

    def _trace_view(self, req, job_id: str, as_json: bool) -> None:
        """Per-job trace timeline from the span log the coordinator keeps
        next to the jhist stream. JSON = Chrome/Perfetto trace_events
        (same payload as `tony-tpu trace`); HTML = a simple Gantt of the
        spans, newest-run-friendly for 'what is the launch path doing'
        incident reads. Live jobs bypass the cache like events do."""
        from tony_tpu_torch import tracing

        job_dir = self._job_dir(job_id)
        if job_dir is None:
            return self._send(req, 404, "text/plain", b"unknown job")
        path = os.path.join(job_dir, constants.TRACE_FILE)
        if not os.path.exists(path):
            return self._send(req, 404, "text/plain",
                              b"no trace recorded for job")
        payload = None
        if not self._job_live(job_id):
            payload = self.cache.get("trace", job_id)
        if payload is None:
            payload = tracing.to_trace_events(tracing.load_records(path))
            if not self._job_live(job_id):
                self.cache.put("trace", job_id, payload)
        if as_json:
            return self._send_json(req, payload)
        spans = [e for e in payload["traceEvents"] if e.get("ph") == "X"]
        if not spans:
            return self._send_html(
                req, f"<h1>trace — {html.escape(job_id)}</h1>"
                     f"<p>no complete spans yet</p>")
        t0 = min(e["ts"] for e in spans)
        t1 = max(e["ts"] + e.get("dur", 0) for e in spans)
        total = max(t1 - t0, 1)
        rows = []
        for e in sorted(spans, key=lambda s: s["ts"]):
            left = 100.0 * (e["ts"] - t0) / total
            width = max(100.0 * e.get("dur", 0) / total, 0.15)
            task = str(e.get("args", {}).get("task", "") or
                       e.get("cat", ""))
            rows.append(
                f"<tr><td>{html.escape(e['name'])}</td>"
                f"<td>{html.escape(task)}</td>"
                f"<td>{(e['ts'] - t0) / 1e3:,.1f}</td>"
                f"<td>{e.get('dur', 0) / 1e3:,.1f}</td>"
                f"<td style='width:50%'><div style='margin-left:"
                f"{left:.2f}%;width:{width:.2f}%;background:#4a90d9;"
                f"height:10px'></div></td></tr>")
        unclosed = payload.get("unclosedSpans", [])
        warn = (f"<p><b>{len(unclosed)} unclosed span(s):</b> "
                f"{html.escape(', '.join(unclosed))}</p>" if unclosed
                else "")
        self._send_html(
            req, f"<h1>trace — {html.escape(job_id)}</h1>"
                 f"<p>trace {html.escape(str(payload.get('traceId', '')))}"
                 f" · {len(spans)} spans · {total / 1e3:,.1f} ms"
                 f" · <a href='/trace/{html.escape(job_id)}?format=json'>"
                 f"Perfetto JSON</a></p>{warn}"
                 f"<table border=1 cellpadding=3 width='100%'>"
                 f"<tr><th>span</th><th>task</th><th>start ms</th>"
                 f"<th>dur ms</th><th>timeline</th></tr>"
                 + "".join(rows) + "</table>")

    def _log_paths(self, job_id: str) -> List[Tuple[str, str]]:
        """(task, path) pairs from the job's own TASK_FINISHED events — the
        only paths this server will ever read (no caller-supplied paths)."""
        evs = self._events(job_id) or []
        out: List[Tuple[str, str]] = []
        for e in evs:
            if e.type == "TASK_FINISHED":
                for p in e.payload.get("logs", []):
                    out.append((e.payload.get("task", "?"), p))
        return out

    def _logs_view(self, req, job_id: str, as_json: bool) -> None:
        pairs = self._log_paths(job_id)
        if as_json:
            return self._send_json(
                req, [dict(task=t, path=p,
                           url=f"/logfile/{job_id}/{i}")
                      for i, (t, p) in enumerate(pairs)])
        items = "".join(
            f"<li>{html.escape(t)}: "
            f"<a href='/logfile/{html.escape(job_id)}/{i}'>"
            f"{html.escape(os.path.basename(p))}</a></li>"
            for i, (t, p) in enumerate(pairs))
        body = f"<ul>{items}</ul>" if items else "<p>no logs recorded</p>"
        self._send_html(
            req, f"<h1>logs — {html.escape(job_id)}</h1>{body}")

    def _profiles_view(self, req, job_id: str, as_json: bool) -> None:
        """Profiler traces captured into <job_dir>/profile by the chief
        (tony_tpu_torch/profiler.py) and the on-demand captures of
        ``cli profile`` (telemetry.py). Listed by capture name; each holds
        a torch.profiler Chrome trace (trace.json) for Perfetto, so the
        portal points at paths rather than rendering."""
        job_dir = self._job_dir(job_id)
        if job_dir is None:
            return self._send(req, 404, "text/plain", b"unknown job")
        root = os.path.join(job_dir, "profile")
        traces = []
        if os.path.isdir(root):
            for name in sorted(os.listdir(root)):
                p = os.path.join(root, name)
                n_files = sum(len(fs) for _, _, fs in os.walk(p))
                traces.append(dict(name=name, path=p, files=n_files))
        if as_json:
            return self._send_json(req, traces)
        items = "".join(
            f"<li>{html.escape(t['name'])} — {t['files']} file(s) at "
            f"<code>{html.escape(t['path'])}</code></li>" for t in traces)
        body = f"<ul>{items}</ul>" if items else "<p>no traces captured</p>"
        self._send_html(
            req, f"<h1>profiler traces — {html.escape(job_id)}</h1>{body}")

    def _logfile_view(self, req, job_id: str, index: int,
                      query: Optional[Dict[str, list]] = None) -> None:
        """Tail of one recorded task log. Seek-based (utils/logs.py —
        a multi-GB log costs only the requested tail, never a whole-file
        read into memory); ``?tail=N`` overrides the byte count."""
        from tony_tpu_torch.utils import logs as logutil

        pairs = self._log_paths(job_id)
        if not 0 <= index < len(pairs):
            return self._send(req, 404, "text/plain", b"no such log")
        path = pairs[index][1]
        tail_bytes = logutil.DEFAULT_TAIL_BYTES
        raw = (query or {}).get("tail", [""])[0]
        if raw:
            try:
                tail_bytes = max(0, int(raw))
            except ValueError:
                return self._send(req, 400, "text/plain",
                                  b"bad ?tail= value (bytes expected)")
        try:
            data = logutil.tail_file(path, tail_bytes)
        except OSError:
            return self._send(req, 404, "text/plain",
                              b"log file no longer present")
        self._send(req, 200, "text/plain; charset=utf-8", data)

    def _diagnose_view(self, req, job_id: str, as_json: bool) -> None:
        """Automatic failure diagnosis (tony_tpu_torch/diagnosis/): serve the
        coordinator-written incident.json for finished jobs; compute a
        PROVISIONAL read live for running ones (never cached — a live
        diagnosis must track the job). HTML and JSON from the same
        document the CLI renders."""
        from tony_tpu_torch import diagnosis

        job_dir = self._job_dir(job_id)
        if job_dir is None:
            return self._send(req, 404, "text/plain", b"unknown job")
        incident = None
        if not self._job_live(job_id):
            incident = diagnosis.load_incident(
                os.path.join(job_dir, constants.INCIDENT_FILE))
        if incident is None:
            incident = diagnosis.diagnose_job_dir(
                job_dir, app_id=job_id,
                provisional=self._job_live(job_id))
        if as_json:
            return self._send_json(req, incident)
        self._send_html(req, diagnosis.render_html(incident))

    # -- plumbing --------------------------------------------------------
    def _send(self, req, code: int, ctype: str, body: bytes) -> None:
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _send_html(self, req, body: str) -> None:
        page = ("<!doctype html><html><head><title>tony-tpu history</title>"
                "</head><body><p><a href='/'>&larr; jobs</a></p>"
                f"{body}</body></html>")
        self._send(req, 200, "text/html; charset=utf-8", page.encode())

    def _send_json(self, req, obj) -> None:
        self._send(req, 200, "application/json",
                   json.dumps(obj, indent=1).encode())


def main(argv=None) -> int:
    """``python -m tony_tpu_torch.portal --history-root ... [--port N]``."""
    import argparse

    from tony_tpu_torch.conf import keys as K
    from tony_tpu_torch.conf.config import TonyTpuConfig

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(prog="tony-tpu-portal")
    p.add_argument("--history-root", required=True)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--token", default=os.environ.get(
        "TONY_PORTAL_TOKEN", ""),
        help="require 'Authorization: Bearer <token>' on every request "
             "(default: $TONY_PORTAL_TOKEN; empty = open — keep the bind "
             "host local then)")
    p.add_argument("--tls-cert", default="",
                   help="PEM cert path: serve HTTPS (pair with --tls-key)")
    p.add_argument("--tls-key", default="",
                   help="PEM private-key path for --tls-cert")
    p.add_argument("--fleet-dir", default="",
                   help="fleet daemon dir for the /fleet view (default: "
                        "auto-discovered when the history root lives "
                        "inside a fleet dir)")
    args = p.parse_args(argv)
    if bool(args.tls_cert) != bool(args.tls_key):
        p.error("--tls-cert and --tls-key must be set together")
    conf = TonyTpuConfig()
    port = args.port if args.port is not None \
        else conf.get_int(K.PORTAL_PORT, 19886)
    srv = PortalServer(
        args.history_root, port=port, host=args.host,
        mover_interval_s=conf.get_int(K.HISTORY_MOVER_INTERVAL_S, 300),
        purger_interval_s=conf.get_int(K.HISTORY_PURGER_INTERVAL_S, 3600),
        retention_days=conf.get_int(K.HISTORY_RETENTION_DAYS, 30),
        token=args.token, tls_cert=args.tls_cert, tls_key=args.tls_key,
        fleet_dir=args.fleet_dir)
    srv.start()
    log.info("portal serving %s at %s", args.history_root, srv.url)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0
