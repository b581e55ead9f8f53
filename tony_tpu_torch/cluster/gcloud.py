"""Cloud TPU API slice provisioner: the framework acquires its own compute.

In the reference, compute acquisition is IN the framework: the AM asks the
YARN ResourceManager for containers (``TaskScheduler.java:101-103``
``addContainerRequest``) and reacts to grants
(``ApplicationMaster.java:1051-1070`` ``onContainersAllocated``). Until now
the TPU analogue was an operator running ``gcloud compute tpus tpu-vm
create`` and pasting IPs into ``tony.slice.hosts`` — the one reference
*role* not yet code. This module closes it the TPU-native way:

- ``TpuApiClient`` — the Cloud TPU v2 REST surface this provisioner speaks
  (create node / poll long-running operation / get node / delete node),
  stdlib HTTP only, bearer auth via ``utils/gcp.GcpBearer`` (explicit
  credential → env token → metadata server) — the same discipline as the
  GCS client (``storage/store.py``), and like it contract-tested against an
  in-process fake API server (``tests/tpu_api_fake_server.py``).
- ``GcloudTpuProvisioner`` — ``SliceProvisioner`` over that client:
  ``acquire(n)`` creates a node, waits for the create operation, polls the
  node to READY, and derives one host channel per ``networkEndpoints``
  entry; ``release`` deletes the node. All-or-nothing holds end-to-end: any
  failure (quota denial, stockout, timeout, endpoint-count mismatch)
  deletes the half-created node and raises ``SliceProvisionError`` — never
  a partial slice.
- ``GcloudSliceLease`` — a lease that also watches the API: preemption and
  suspension flip the node's ``state`` server-side, so ``check()`` (called
  from the backend's poll loop) surfaces a terminal state as host loss on
  every channel. That feeds the EXISTING recovery machinery unchanged —
  tasks report ``HOST_LOST_EXIT``, the coordinator kills the gang and
  starts a retry epoch, ``_ensure_lease`` releases the broken lease
  (deleting the preempted node) and acquires a fresh one — so
  preempt → re-create → resume-from-checkpoint needs no new control flow
  (the analogue of ``onTaskDeemedDead`` → AM reset,
  ``ApplicationMaster.java:1178-1185``).

The slice stays indivisible: one node == one lease == the whole gang
(SURVEY.md §7 hard part (a)); the v2 API's multi-host node IS the atomic
grant, which is why there is no per-container bookkeeping here.

The port keeps this provisioner as the reference has it, held to the same
REST contract, under the ``gpu-host`` backend (``cluster/gpu.py``): its
leases are ordinary ``SliceLease`` objects over ssh or LocalSim channels.
A provisioner of GPU VMs through another cloud's API would be a feature the
reference lacks; it is out of scope (ROADMAP).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional

from tony_tpu_torch.cluster.gpu import (HostChannel, LocalSimHostChannel,
                                        SliceLease, SliceProvisionError,
                                        SliceProvisioner, SshHostChannel)
from tony_tpu_torch.utils.gcp import GcpBearer, json_request

log = logging.getLogger(__name__)

TPU_API_ENDPOINT_ENV = "TONY_TPU_API_ENDPOINT"
_DEFAULT_ENDPOINT = "https://tpu.googleapis.com"

#: node states that invalidate a lease (the slice cannot come back: spot
#: reclaim, manual stop, deletion). CREATING/REPAIRING are NOT terminal —
#: REPAIRING nodes return to READY and killing the gang for them would turn
#: a maintenance blip into a retry epoch.
TERMINAL_STATES = frozenset({
    "PREEMPTED", "TERMINATED", "STOPPED", "STOPPING", "SUSPENDED",
    "SUSPENDING", "DELETING", "DELETED", "FAILED"})

#: queued-resource states that are a RECLAIM NOTICE: the provider has
#: decided to take the capacity back but the nodes still run — the
#: warning window the fleet daemon's proactive live migration spends
#: moving jobs OFF the doomed slice (fleet/daemon.py ``_poll_reclaim``)
#: instead of absorbing host losses after the reclaim lands.
RECLAIM_NOTICE_STATES = frozenset({"SUSPENDING"})


def reclaim_notices(api: "TpuApiClient") -> List[str]:
    """Queued-resource ids the provider is actively reclaiming — the
    production feed behind the fleet daemon's slice-preemption intake
    (drills use the ``slice.preempt`` fault site instead). A flaky API
    yields no notices, never an exception: a poll hiccup must not read
    as a reclaim."""
    try:
        qrs = api.list_queued_resources()
    except Exception as e:  # noqa: BLE001 — a flaky feed is no notice
        log.debug("queued-resource reclaim poll failed: %s", e)
        return []
    out: List[str] = []
    for qr in qrs:
        state = str((qr.get("state") or {}).get("state", ""))
        if state in RECLAIM_NOTICE_STATES:
            name = str(qr.get("name", "") or "")
            out.append(name.rsplit("/", 1)[-1] or name)
    return sorted(out)


class TpuApiError(RuntimeError):
    """Non-transient Cloud TPU API failure (carries the HTTP code)."""

    def __init__(self, msg: str, code: int = 0):
        super().__init__(msg)
        self.code = code


class TpuApiClient:
    """The slice of the Cloud TPU v2 REST API the provisioner needs.

    Same wire discipline as ``GcsStore._request``: bounded retry with
    backoff on 429/5xx/transport errors, 404 → FileNotFoundError, 401/403
    → one cached-token refresh then ``TpuApiError`` — long jobs must
    survive token expiry between the create and the (hours-later) delete.
    """

    def __init__(self, project: str, zone: str,
                 endpoint: Optional[str] = None,
                 credential: Optional[str] = None,
                 retries: int = 4, backoff_s: float = 1.0,
                 timeout_s: float = 60.0):
        if not project or not zone:
            raise ValueError("TpuApiClient needs a project and a zone")
        self.project = project
        self.zone = zone
        self.endpoint = (endpoint or os.environ.get(TPU_API_ENDPOINT_ENV)
                         or _DEFAULT_ENDPOINT).rstrip("/")
        self._auth = GcpBearer(credential)
        self.retries = retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s

    def probe_clone(self) -> "TpuApiClient":
        """A low-latency sibling for health probes: no retries, short
        timeout, SAME auth cache. Control-plane mutations want the full
        retry discipline; a periodic health check running inside the
        coordinator's poll loop must never stall it for minutes on an
        API blip (it tolerates failure anyway — it just returns)."""
        clone = TpuApiClient.__new__(TpuApiClient)
        clone.__dict__.update(self.__dict__)
        clone.retries = 0
        clone.timeout_s = 10.0
        return clone

    @property
    def parent(self) -> str:
        return f"projects/{self.project}/locations/{self.zone}"

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> dict:
        return json_request(method, f"{self.endpoint}/v2/{path}",
                            auth=self._auth, body=body,
                            retries=self.retries, backoff_s=self.backoff_s,
                            timeout_s=self.timeout_s,
                            error_cls=TpuApiError)

    # -- the four calls the provisioner makes --------------------------
    def create_node(self, node_id: str, node_body: dict) -> dict:
        """POST …/nodes?nodeId= → a long-running operation dict."""
        return self._request("POST",
                             f"{self.parent}/nodes?nodeId={node_id}",
                             body=node_body)

    def get_node(self, node_id: str) -> dict:
        return self._request("GET", f"{self.parent}/nodes/{node_id}")

    # -- queued resources (the capacity-queue acquisition path) --------
    def create_queued_resource(self, qr_id: str, body: dict) -> dict:
        return self._request(
            "POST",
            f"{self.parent}/queuedResources?queuedResourceId={qr_id}",
            body=body)

    def get_queued_resource(self, qr_id: str) -> dict:
        return self._request("GET",
                             f"{self.parent}/queuedResources/{qr_id}")

    def delete_queued_resource(self, qr_id: str,
                               force: bool = True) -> dict:
        return self._request(
            "DELETE", f"{self.parent}/queuedResources/{qr_id}"
            + ("?force=true" if force else ""))

    def _list_paged(self, collection: str, item_key: str) -> List[dict]:
        """Paginated zone listing, following ``nextPageToken`` to the end
        (same discipline as the GCS listing — a janitor that only reads
        page 1 'finds no leaks' while billing resources sit on page 2)."""
        from urllib.parse import quote

        items: List[dict] = []
        token = ""
        while True:
            path = f"{self.parent}/{collection}"
            if token:
                path += f"?pageToken={quote(token, safe='')}"
            page = self._request("GET", path)
            items += page.get(item_key, [])
            token = page.get("nextPageToken", "")
            if not token:
                return items

    def list_nodes(self) -> List[dict]:
        """All nodes in the zone (the janitor's view — ``cli gcloud-gc``)."""
        return self._list_paged("nodes", "nodes")

    def list_queued_resources(self) -> List[dict]:
        """All queued resources in the zone — a hard-crashed coordinator
        can leak a WAITING request that later grants and bills."""
        return self._list_paged("queuedResources", "queuedResources")

    def delete_node(self, node_id: str) -> dict:
        return self._request("DELETE", f"{self.parent}/nodes/{node_id}")

    def get_operation(self, op_name: str) -> dict:
        """``op_name`` is the full resource name the API returned
        (``projects/…/locations/…/operations/…``)."""
        return self._request("GET", op_name)

    def wait_operation(self, op: dict, timeout_s: float,
                       interval_s: float) -> dict:
        """Poll a long-running operation to ``done``; raise on op error."""
        deadline = time.monotonic() + timeout_s
        while not op.get("done"):
            if time.monotonic() > deadline:
                raise TpuApiError(
                    f"operation {op.get('name')} not done after "
                    f"{timeout_s:.0f}s")
            time.sleep(interval_s)
            op = self.get_operation(op["name"])
        if "error" in op:
            err = op["error"]
            raise TpuApiError(
                f"operation {op.get('name')} failed: "
                f"{err.get('message', err)}", code=int(err.get("code", 0)))
        return op


class GcloudSliceLease(SliceLease):
    """A lease whose health has two sources: the channels (is the VM
    reachable?) and the API (has the cloud taken the node away?)."""

    def __init__(self, slice_id: str, hosts: List[HostChannel],
                 api: TpuApiClient, poll_interval_s: float):
        super().__init__(slice_id, hosts)
        # Health probes ride a no-retry/short-timeout clone so a flaky
        # API endpoint cannot stall the coordinator's poll loop.
        self._api = api.probe_clone()
        self._poll_interval_s = poll_interval_s
        self._last_check = 0.0
        self.terminal_state: Optional[str] = None

    def check(self) -> None:
        """Poll the node state (rate-limited); a terminal state marks every
        host lost, which the backend's normal poll loop then reports as
        ``HOST_LOST_EXIT`` for the tasks on them. Called from
        ``GpuHostBackend.poll_completions``."""
        if self.terminal_state is not None:
            return
        now = time.monotonic()
        if now - self._last_check < self._poll_interval_s:
            return
        self._last_check = now
        try:
            node = self._api.get_node(self.slice_id)
            state = str(node.get("state", ""))
        except FileNotFoundError:
            state = "DELETED"
        except Exception as e:  # noqa: BLE001
            # A transient API hiccup is not evidence the slice died; the
            # ssh-liveness side of lost_hosts() still stands guard.
            log.debug("node state poll for %s failed: %s", self.slice_id, e)
            return
        if state in TERMINAL_STATES:
            log.warning("node %s entered terminal state %s; marking all "
                        "%d hosts lost", self.slice_id, state,
                        len(self.hosts))
            self.terminal_state = state
            for h in self.hosts:
                h.mark_lost()

    def lost_hosts(self) -> List[HostChannel]:
        self.check()
        return super().lost_hosts()


class GcloudTpuProvisioner(SliceProvisioner):
    """``SliceProvisioner`` over the Cloud TPU API (module docstring).

    ``channel_factory(host_id, endpoint_dict) -> HostChannel`` defaults to
    ssh channels onto the node's internal IPs (TPU VMs in the same VPC —
    the production shape); tests inject ``localsim_channel_factory`` so the
    full create/READY/preempt/delete lifecycle runs against the fake API
    server with real local executors and no hardware."""

    def __init__(self, api: TpuApiClient, accelerator_type: str,
                 runtime_version: str, node_prefix: str = "tony",
                 ssh_user: str = "", remote_python: str = "python3",
                 create_timeout_s: float = 900.0,
                 poll_interval_s: float = 5.0, spot: bool = False,
                 network: str = "", queued: bool = False,
                 channel_factory: Optional[
                     Callable[[str, dict], HostChannel]] = None):
        if not accelerator_type or not runtime_version:
            raise SliceProvisionError(
                "gcloud provisioner needs tony.gcloud.accelerator-type "
                "and tony.gcloud.runtime-version")
        self.api = api
        self.accelerator_type = accelerator_type
        self.runtime_version = runtime_version
        self.node_prefix = node_prefix
        self.ssh_user = ssh_user
        self.remote_python = remote_python
        self.create_timeout_s = create_timeout_s
        self.poll_interval_s = poll_interval_s
        self.spot = spot
        self.network = network
        #: acquire capacity via the queued-resources API instead of a
        #: direct node create — the path real TPU capacity is commonly
        #: granted through (reservations/spot queues): the request WAITS
        #: in the provider's queue until capacity exists, then the node
        #: materializes. tony.gcloud.queued-resource.
        self.queued = queued
        self._channel_factory = channel_factory or self._ssh_channel
        #: node ids this provisioner created and has not yet deleted —
        #: release() only ever deletes its own nodes. Value records the
        #: acquisition mode ("node" | "qr") so release tears down the
        #: right resources.
        self._owned: Dict[str, str] = {}

    # -- channels ------------------------------------------------------
    def _ssh_channel(self, host_id: str, endpoint: dict) -> HostChannel:
        ip = endpoint.get("ipAddress", "")
        access = endpoint.get("accessConfig") or {}
        target = ip or access.get("externalIp", "")
        if self.ssh_user:
            target = f"{self.ssh_user}@{target}"
        return SshHostChannel(host_id=host_id, ssh_target=target,
                              python=self.remote_python)

    # -- SliceProvisioner ----------------------------------------------
    def _node_body(self, nonce: str,
                   include_scheduling: bool = True) -> dict:
        body: dict = {
            "acceleratorType": self.accelerator_type,
            "runtimeVersion": self.runtime_version,
            # The nonce makes THIS create attempt identifiable: a 409
            # whose existing node carries it is our own create with a
            # lost response, not someone else's node (see acquire).
            "labels": {"tony-managed": "true", "tony-nonce": nonce},
        }
        if self.spot and include_scheduling:
            # Direct create only: on the queued path the tier is
            # expressed on the QueuedResource envelope and the API
            # rejects schedulingConfig inside a QR node spec.
            body["schedulingConfig"] = {"preemptible": True}
        if self.network:
            body["networkConfig"] = {"network": self.network}
        return body

    def acquire(self, n_hosts: int, node_pool: str = "") -> SliceLease:
        # ONE deadline for the whole acquire (create op + READY polling)
        # — tony.gcloud.create-timeout-s promises a bound on the sum, not
        # per phase.
        deadline = time.monotonic() + self.create_timeout_s
        if self.queued:
            return self._acquire_queued(n_hosts, deadline)
        node_id = ""
        op: Optional[dict] = None
        last_err: Optional[Exception] = None
        for _ in range(3):
            node_id = f"{self.node_prefix}-{os.urandom(3).hex()}"
            nonce = os.urandom(8).hex()
            try:
                op = self.api.create_node(node_id, self._node_body(nonce))
                break
            except TpuApiError as e:
                if e.code == 409:
                    # Two ways to 409 on a name WE just randomized: our
                    # own create succeeded but its response was lost and
                    # the transport retry hit the existing node, or
                    # another job really holds the name. The per-attempt
                    # nonce label distinguishes them exactly — only OUR
                    # lost create carries this nonce, so a concurrent
                    # tony job's node can never be adopted (and later
                    # deleted) by mistake.
                    if self._probe_is_ours(node_id, nonce):
                        log.warning(
                            "create of %s 409'd but the node is ours "
                            "(lost create response); adopting", node_id)
                        op = None           # no operation left to wait on
                        break
                    last_err = e
                    continue
                raise SliceProvisionError(
                    f"TPU node create denied: {e}") from e
        else:
            raise SliceProvisionError(
                f"could not find a free node name: {last_err}")
        self._owned[node_id] = "node"
        try:
            if op is not None:
                self.api.wait_operation(
                    op, max(0.0, deadline - time.monotonic()),
                    self.poll_interval_s)
            node = self._await_ready(node_id, deadline)
            return self._lease_from_node(node_id, node, n_hosts)
        except BaseException as e:
            # All-or-nothing: never leak a half-created (and billing!)
            # node behind a failed acquire.
            self._delete_quietly(node_id)
            if isinstance(e, SliceProvisionError):
                raise
            raise SliceProvisionError(
                f"TPU node {node_id} did not become READY: {e}") from e

    def _lease_from_node(self, node_id: str, node: dict,
                         n_hosts: int) -> SliceLease:
        endpoints = node.get("networkEndpoints") or []
        if len(endpoints) != n_hosts:
            raise SliceProvisionError(
                f"node {node_id} ({self.accelerator_type}) has "
                f"{len(endpoints)} hosts but the job needs {n_hosts} — "
                f"fix tony.slice.num-hosts or the accelerator type")
        hosts = [self._channel_factory(f"{node_id}-host-{i}", ep)
                 for i, ep in enumerate(endpoints)]
        log.info("leased TPU node %s (%s): %d hosts", node_id,
                 self.accelerator_type, len(hosts))
        return GcloudSliceLease(node_id, hosts, self.api,
                                self.poll_interval_s)

    #: queued-resource states that will never become ACTIVE
    _QR_TERMINAL = frozenset({"FAILED", "SUSPENDED", "SUSPENDING"})

    def _acquire_queued(self, n_hosts: int, deadline: float) -> SliceLease:
        """Capacity via the queued-resources API: the request waits in
        the provider's queue (WAITING_FOR_RESOURCES → PROVISIONING →
        ACTIVE) and the node materializes when granted. Same
        all-or-nothing contract: any failure deletes the queued resource
        (force — taking its half-created node with it)."""
        qr_id = ""
        last_err: Optional[Exception] = None
        for _ in range(3):
            qr_id = f"{self.node_prefix}-{os.urandom(3).hex()}"
            nonce = os.urandom(8).hex()
            body: dict = {"tpu": {"nodeSpec": [{
                "parent": self.api.parent,
                "nodeId": qr_id,
                "node": self._node_body(nonce, include_scheduling=False),
            }]}}
            # Queued-resource tier rides the QR, not schedulingConfig.
            # Plain on-demand omits BOTH tier fields — "guaranteed" means
            # reservation/commitment capacity the project may not hold.
            if self.spot:
                body["spot"] = {}
            try:
                self.api.create_queued_resource(qr_id, body)
                break
            except TpuApiError as e:
                if e.code == 409:
                    # Same lost-response hazard as the direct path: our
                    # create may have landed server-side with the
                    # response dropped, and abandoning that WAITING
                    # request would let it grant and bill a node nobody
                    # owns. The per-attempt nonce distinguishes ours.
                    if self._probe_qr_is_ours(qr_id, nonce):
                        log.warning(
                            "queued-resource create of %s 409'd but the "
                            "request is ours (lost response); adopting",
                            qr_id)
                        break
                    last_err = e    # true collision: new random suffix
                    continue
                raise SliceProvisionError(
                    f"queued-resource create denied: {e}") from e
        else:
            raise SliceProvisionError(
                f"could not find a free queued-resource name: {last_err}")
        self._owned[qr_id] = "qr"
        try:
            self._poll_state(
                fetch=lambda: self.api.get_queued_resource(qr_id),
                state_of=lambda qr: str(
                    (qr.get("state") or {}).get("state", "")),
                ready_state="ACTIVE", terminal=self._QR_TERMINAL,
                deadline=deadline, what=f"queued resource {qr_id}",
                stuck_hint="no capacity granted within the acquire "
                           "budget",
                # Right after create the QR may not be GETtable yet
                # (the create LRO is still materializing it) — a 404
                # within the deadline is "not visible yet", not gone.
                tolerate_missing=True)
            # ACTIVE: the node exists; poll it to READY like the direct
            # path (endpoints appear with READY).
            node = self._await_ready(qr_id, deadline)
            return self._lease_from_node(qr_id, node, n_hosts)
        except BaseException as e:
            self._delete_quietly(qr_id)
            if isinstance(e, SliceProvisionError):
                raise
            raise SliceProvisionError(
                f"queued resource {qr_id} did not become ACTIVE: "
                f"{e}") from e

    def _probe_is_ours(self, node_id: str, nonce: str) -> bool:
        """After a 409 on a name we generated: does the node carry the
        nonce of THIS create attempt? (The lost-create-response case.)"""
        try:
            node = self.api.get_node(node_id)
        except Exception:  # noqa: BLE001 — can't tell: treat as not ours
            return False
        return node.get("labels", {}).get("tony-nonce") == nonce

    def _probe_qr_is_ours(self, qr_id: str, nonce: str) -> bool:
        """QR flavor of the lost-create-response probe: the nonce lives
        in the queued resource's embedded node spec labels."""
        try:
            qr = self.api.get_queued_resource(qr_id)
        except Exception:  # noqa: BLE001 — can't tell: treat as not ours
            return False
        specs = (qr.get("tpu") or {}).get("nodeSpec") or []
        for spec in specs:
            labels = (spec.get("node") or {}).get("labels") or {}
            if labels.get("tony-nonce") == nonce:
                return True
        return False

    def _poll_state(self, fetch, state_of, ready_state: str,
                    terminal: frozenset, deadline: float, what: str,
                    stuck_hint: str = "",
                    tolerate_missing: bool = False) -> dict:
        """ONE poll-until-ready-or-terminal-or-deadline loop for both
        resource kinds (node READY, queued resource ACTIVE) — two copies
        of the deadline/terminal semantics would drift."""
        while True:
            state = ""
            try:
                res = fetch()
                state = state_of(res)
                if state == ready_state:
                    return res
                if state in terminal:
                    raise SliceProvisionError(
                        f"{what} became {state} while waiting for "
                        f"{ready_state}")
            except FileNotFoundError:
                if not tolerate_missing:
                    raise
                state = "(not yet visible)"
            if time.monotonic() > deadline:
                raise SliceProvisionError(
                    f"{what} still {state or '?'} after "
                    f"{self.create_timeout_s:.0f}s"
                    + (f" — {stuck_hint}" if stuck_hint else ""))
            time.sleep(self.poll_interval_s)

    def _await_ready(self, node_id: str, deadline: float) -> dict:
        """The create op finishing does not mean the node is usable —
        poll the node itself to READY (the API may report CREATING for a
        while after, and endpoints appear only when READY). ``deadline``
        is the acquire-wide monotonic bound."""
        return self._poll_state(
            fetch=lambda: self.api.get_node(node_id),
            state_of=lambda n: str(n.get("state", "")),
            ready_state="READY", terminal=TERMINAL_STATES,
            deadline=deadline, what=f"node {node_id}",
            stuck_hint="stockout/preempt during create")

    def _delete_quietly(self, node_id: str) -> None:
        mode = self._owned.get(node_id, "node")
        try:
            if mode == "qr":
                # force=true takes the queued resource AND its node in
                # one call, whatever state the grant reached.
                op = self.api.delete_queued_resource(node_id, force=True)
            else:
                op = self.api.delete_node(node_id)
            self.api.wait_operation(op, timeout_s=120,
                                    interval_s=self.poll_interval_s)
        except FileNotFoundError:
            pass                        # already gone
        except Exception as e:  # noqa: BLE001
            log.warning("best-effort delete of %s %s failed: %s",
                        mode, node_id, e)
        finally:
            self._owned.pop(node_id, None)

    def release(self, lease: SliceLease) -> None:
        if lease.slice_id not in self._owned:
            log.warning("release of unknown lease %s ignored",
                        lease.slice_id)
            return
        log.info("deleting TPU node %s", lease.slice_id)
        self._delete_quietly(lease.slice_id)


def localsim_channel_factory(workroot: str
                             ) -> Callable[[str, dict], HostChannel]:
    """Test-substrate channels for the gcloud provisioner: each endpoint
    the (fake) API reports becomes a LocalSimHostChannel, so the whole
    create → READY → run → preempt → delete lifecycle is e2e-testable with
    real executors and no cloud (``tony.gcloud.channel=localsim``)."""
    def factory(host_id: str, endpoint: dict) -> HostChannel:
        return LocalSimHostChannel(host_id, os.path.join(workroot, host_id))
    return factory
