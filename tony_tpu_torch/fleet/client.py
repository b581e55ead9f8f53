"""Thin fleet RPC client over the fleet address file.

The fleet-side twin of ``pool.PoolClient``: resolve ``fleet.addr`` in
the fleet dir, dial the daemon over the ordinary token-authed RPC plane,
and carry the daemon's journaled generation on every frame — a zombie
daemon superseded by a ``--recover`` restart fences itself out of the
conversation (rpc/wire.py StaleGenerationError) instead of accepting
submissions into a dead queue.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from tony_tpu_torch import constants


class FleetClientError(RuntimeError):
    """The daemon is absent/unreachable or answered malformed — callers
    surface this to the operator (there is no cold-path fallback: with
    no fleet there is nowhere to queue)."""


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


class FleetClient:
    def __init__(self, fleet_dir: str):
        self.fleet_dir = os.path.abspath(os.path.expanduser(fleet_dir))
        self._rpc: Optional[Any] = None

    def _client(self) -> Any:
        if self._rpc is None:
            addr = _read_json(os.path.join(self.fleet_dir,
                                           constants.FLEET_ADDR_FILE))
            if not addr:
                raise FleetClientError(
                    f"no fleet daemon running under {self.fleet_dir} "
                    f"(start one with `tony-tpu fleet start`)")
            from tony_tpu_torch.rpc.wire import RpcClient

            self._rpc = RpcClient(
                addr["host"], int(addr["port"]),
                token=addr.get("token") or None,
                generation=int(addr.get("generation", 0) or 0),
                max_retries=2, retry_sleep_s=0.2,
                connect_timeout_s=3.0, call_timeout_s=30.0, peer="fleet")
        return self._rpc

    def call(self, method: str, **args: Any) -> Any:
        try:
            return self._client().call(method, **args)
        except FleetClientError:
            raise
        except Exception as e:  # noqa: BLE001 — normalize transport errors
            self.close()
            raise FleetClientError(
                f"fleet rpc {method} failed: {e}") from e

    def submit(self, tenant: str, hosts: int, priority: int = 0,
               min_hosts: int = 0, model: str = "",
               conf: Optional[Dict[str, str]] = None) -> dict:
        res = self.call("fleet.submit", tenant=tenant, hosts=int(hosts),
                        priority=int(priority),
                        min_hosts=int(min_hosts), model=model,
                        conf=dict(conf or {}))
        if not isinstance(res, dict):
            raise FleetClientError(f"malformed submit response: {res!r}")
        return res

    def status(self) -> dict:
        res = self.call("fleet.status")
        if not isinstance(res, dict):
            raise FleetClientError(f"malformed status response: {res!r}")
        return res

    def cancel(self, job: str) -> dict:
        res = self.call("fleet.cancel", job=job)
        if not isinstance(res, dict):
            raise FleetClientError(f"malformed cancel response: {res!r}")
        return res

    def explain(self, job: str) -> dict:
        """The scheduler decision explainer: the job's causal hold
        timeline (reason transitions with blockers named) plus its
        grant/resize/finish milestones."""
        res = self.call("fleet.explain", job=job)
        if not isinstance(res, dict):
            raise FleetClientError(
                f"malformed explain response: {res!r}")
        return res

    def migrate(self, job: str, target: int) -> dict:
        """Operator-initiated live move of a running fleet job to
        another slice (defrag by hand, pre-maintenance evacuation)."""
        res = self.call("fleet.migrate", job=job, target=int(target))
        if not isinstance(res, dict):
            raise FleetClientError(
                f"malformed migrate response: {res!r}")
        return res

    def cordon(self, host: str, reason: str = "") -> dict:
        """Operator cordon: pull one host out of the placement pool
        (pre-maintenance, suspected hardware). Manual cordons never
        auto-expire — close them with uncordon."""
        res = self.call("fleet.cordon", host=host, reason=reason)
        if not isinstance(res, dict):
            raise FleetClientError(
                f"malformed cordon response: {res!r}")
        return res

    def uncordon(self, host: str) -> dict:
        res = self.call("fleet.uncordon", host=host)
        if not isinstance(res, dict):
            raise FleetClientError(
                f"malformed uncordon response: {res!r}")
        return res

    def health(self) -> dict:
        """The host-health ledger: per-host state/score/evidence rows,
        the current cordon set and any sick slices."""
        res = self.call("fleet.health")
        if not isinstance(res, dict):
            raise FleetClientError(
                f"malformed health response: {res!r}")
        return res

    def alerts(self) -> dict:
        """The fleet-scope alert engine: per-rule state machine rows
        plus the degrade flag (evaluation disabled after a fault)."""
        res = self.call("fleet.alerts")
        if not isinstance(res, dict):
            raise FleetClientError(
                f"malformed alerts response: {res!r}")
        return res

    def prom(self) -> str:
        """Live Prometheus exposition from the daemon's own registry
        (the file under the fleet dir refreshes only on the export
        cadence)."""
        res = self.call("fleet.prom")
        if not isinstance(res, dict) or "text" not in res:
            raise FleetClientError(
                f"malformed prom response: {res!r}")
        return str(res["text"])

    def stop(self) -> None:
        self.call("fleet.stop")

    def close(self) -> None:
        if self._rpc is not None:
            try:
                self._rpc.close()
            except Exception:  # noqa: BLE001
                pass
            self._rpc = None
