"""The port's Cloud TPU API provisioner (tony_tpu_torch/cluster/gcloud.py)
under the ``gpu-host`` backend: the wire-level contract tests of
``tests/test_gcloud_provisioner.py`` against the same in-process fake API
server (``tpu_api_fake_server.py``), ``cli gcloud-gc``, plus the composed
preemption→re-create→resume e2e through the port's client, coordinator
and executors.

The reference's account follows.

This closes the last reference role that was still an operator's job:
the framework itself asks the resource manager
for compute and reacts to grants — the analogue of
``TaskScheduler.java:101-103`` ``addContainerRequest`` /
``ApplicationMaster.java:1051-1070`` ``onContainersAllocated`` — except
the grant is an atomic multi-host TPU node, not incremental containers.
Tested the way the GCS client was: the double verifies the client's
REQUESTS (create/poll/get/delete wire traffic), the e2e verifies the
composed lifecycle with real executors.
"""

import os

import pytest

from tony_tpu_torch import constants
from tony_tpu_torch.checkpoint.manager import MANIFEST_NAME
from tony_tpu_torch.cluster.gcloud import (GcloudTpuProvisioner, TpuApiClient,
                                     TpuApiError, localsim_channel_factory)
from tony_tpu_torch.cluster.gpu import SliceProvisionError, SshHostChannel
from tony_tpu_torch.conf import keys as K

from test_torch_cluster_gpu import (RESUME_SCRIPT, _script, make_conf,
                                    submit)
from test_torch_e2e import _dump as _dump_task_logs
from tpu_api_fake_server import TpuApiFakeServer


def _api(server, **kw):
    kw.setdefault("credential", "t0k")
    kw.setdefault("backoff_s", 0.01)
    return TpuApiClient(project="proj", zone="us-central2-b",
                        endpoint=server.endpoint, **kw)


def _prov(api, **kw):
    kw.setdefault("accelerator_type", "v5litepod-16")
    kw.setdefault("runtime_version", "tpu-ubuntu2204-base")
    kw.setdefault("create_timeout_s", 10.0)
    kw.setdefault("poll_interval_s", 0.02)
    return GcloudTpuProvisioner(api, **kw)


# ---------------------------------------------------------------------------
# Contract: acquire / release wire behavior
# ---------------------------------------------------------------------------
def test_acquire_creates_node_polls_ready_and_builds_ssh_channels():
    server = TpuApiFakeServer(hosts_per_node=2, ready_after_polls=2,
                              op_done_after_polls=2).start()
    try:
        prov = _prov(_api(server), ssh_user="tony")
        lease = prov.acquire(2)
        assert len(server.created_names) == 1
        node_id = server.created_names[0]
        assert lease.slice_id == node_id
        assert node_id.startswith("tony-")
        # one ssh channel per networkEndpoints entry, internal IPs,
        # login user applied, host ids carry the slice ordinal
        assert [type(h) for h in lease.hosts] == [SshHostChannel] * 2
        assert [h.ssh_target for h in lease.hosts] == \
            ["tony@10.0.0.1", "tony@10.0.0.2"]
        assert [h.host_id for h in lease.hosts] == \
            [f"{node_id}-host-0", f"{node_id}-host-1"]
        # the created node asked for the configured shape
        node = server.nodes[node_id]
        assert node["acceleratorType"] == "v5litepod-16"
        assert node["runtimeVersion"] == "tpu-ubuntu2204-base"
        assert node["state"] == "READY"
        prov.release(lease)
        assert server.deleted_names == [node_id]
        assert node_id not in server.nodes      # delete op completed
    finally:
        server.stop()


def test_spot_flag_rides_scheduling_config():
    server = TpuApiFakeServer().start()
    try:
        prov = _prov(_api(server), spot=True,
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        node = server.nodes[lease.slice_id]
        assert node["schedulingConfig"] == {"preemptible": True}
        prov.release(lease)
    finally:
        server.stop()


def _localsim(hid):
    from tony_tpu_torch.cluster.gpu import LocalSimHostChannel
    import tempfile
    return LocalSimHostChannel(hid, tempfile.mkdtemp(prefix="tony-gc-"))


def test_denied_create_maps_to_provision_error_without_leaks():
    """Quota/stockout (RESOURCE_EXHAUSTED on create) must become a clean
    SliceProvisionError — and no node may be left behind."""
    server = TpuApiFakeServer(deny_creates=10).start()
    try:
        prov = _prov(_api(server, retries=1))
        with pytest.raises(SliceProvisionError, match="create denied"):
            prov.acquire(1)
        assert server.nodes == {}
    finally:
        server.stop()


def test_transient_stockout_retried_within_bounds():
    """One 429 then capacity: the bounded retry inside the API client
    absorbs a transient denial (same discipline as the GCS client)."""
    server = TpuApiFakeServer(deny_creates=1).start()
    try:
        prov = _prov(_api(server, retries=2),
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        assert lease.slice_id in server.nodes
        prov.release(lease)
    finally:
        server.stop()


def test_endpoint_count_mismatch_deletes_node():
    """All-or-nothing: an accelerator type whose host count differs from
    the job's tony.slice.num-hosts must not strand a billing node."""
    server = TpuApiFakeServer(hosts_per_node=1).start()
    try:
        prov = _prov(_api(server))
        with pytest.raises(SliceProvisionError, match="1 hosts but"):
            prov.acquire(2)
        assert server.nodes == {}
        assert server.delete_count == 1
    finally:
        server.stop()


def test_create_timeout_deletes_node():
    server = TpuApiFakeServer(stuck_in_creating=True).start()
    try:
        prov = _prov(_api(server), create_timeout_s=0.2,
                     poll_interval_s=0.02)
        with pytest.raises(SliceProvisionError, match="still CREATING"):
            prov.acquire(1)
        assert server.nodes == {}
    finally:
        server.stop()


def test_name_conflict_retries_with_fresh_suffix(monkeypatch):
    """409 on create (name collision) picks another random suffix instead
    of failing the job."""
    seq = [b"\x00\x00\x00", b"\x00\x00\x01"]
    real_urandom = os.urandom
    monkeypatch.setattr(
        "tony_tpu_torch.cluster.gcloud.os.urandom",
        lambda n: seq.pop(0) if seq and n == 3 else real_urandom(n))
    server = TpuApiFakeServer().start()
    try:
        # Seed the colliding name as an existing node.
        server.nodes["tony-000000"] = {"name": "x", "state": "READY",
                                       "networkEndpoints": []}
        prov = _prov(_api(server),
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        assert lease.slice_id == "tony-000001"
        prov.release(lease)
    finally:
        server.stop()


def test_lost_create_response_adopts_own_node(monkeypatch):
    """A 409 on a name whose node carries THIS attempt's nonce label is
    our own create whose response was lost mid-retry — the provisioner
    must adopt that (running, billing) node, not abandon it. A node
    without the nonce (another job's) is never adopted — see
    test_name_conflict_retries_with_fresh_suffix."""
    seq = [b"\x00\x00\x00"]
    real_urandom = os.urandom
    monkeypatch.setattr(
        "tony_tpu_torch.cluster.gcloud.os.urandom",
        lambda n: (seq.pop(0) if seq and n == 3
                   else b"\x00" * 8 if n == 8 else real_urandom(n)))
    server = TpuApiFakeServer().start()
    try:
        # The pre-existing node looks exactly like what our create built —
        # crucially including the per-attempt nonce label.
        server.nodes["tony-000000"] = {
            "name": "projects/proj/locations/z/nodes/tony-000000",
            "state": "READY", "acceleratorType": "v5litepod-16",
            "labels": {"tony-managed": "true",
                       "tony-nonce": "00" * 8},
            "networkEndpoints": [{"ipAddress": "10.9.9.9", "port": 8470}]}
        prov = _prov(_api(server),
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        assert lease.slice_id == "tony-000000"      # adopted, not renamed
        prov.release(lease)
        assert "tony-000000" in server.deleted_names  # and owned: deletable
    finally:
        server.stop()


def test_forced_lost_ssh_host_reports_tasks_without_tcp_timeout():
    """mark_lost() on an ssh channel must surface running tasks as
    HOST_LOST_EXIT immediately — a SUSPENDED VM drops packets silently and
    the local ssh client can sit in TCP timeout for minutes, which would
    wedge gang_active() and block the re-lease."""
    import subprocess

    ch = SshHostChannel(host_id="h", ssh_target="h")
    sleeper = subprocess.Popen(["sleep", "30"])
    try:
        handle = {"popen": sleeper, "workdir": "/nonexistent"}
        assert ch.poll(handle) is None
        ch.mark_lost()
        assert not ch.alive()
        from tony_tpu_torch.cluster.gpu import HOST_LOST_EXIT
        assert ch.poll(handle) == HOST_LOST_EXIT
    finally:
        sleeper.kill()
        sleeper.wait()


def test_bearer_auth_enforced_and_sent():
    server = TpuApiFakeServer(require_token="s3cr3t").start()
    try:
        good = _prov(_api(server, credential="s3cr3t"),
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = good.acquire(1)
        good.release(lease)
        bad = _prov(_api(server, credential="wrong"))
        with pytest.raises(SliceProvisionError, match="denied"):
            bad.acquire(1)
    finally:
        server.stop()


def test_transient_5xx_survived():
    server = TpuApiFakeServer(fail_first_n=2).start()
    try:
        prov = _prov(_api(server, retries=3),
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        prov.release(lease)
    finally:
        server.stop()


def test_release_of_already_deleted_node_is_quiet():
    server = TpuApiFakeServer().start()
    try:
        prov = _prov(_api(server),
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        prov.release(lease)
        prov.release(lease)         # second release: no raise, no request
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# Queued-resource acquisition (tony.gcloud.queued-resource)
# ---------------------------------------------------------------------------
def test_queued_resource_acquire_waits_for_grant_then_leases(tmp_path):
    """Capacity via the queued-resources API: the request WAITS in the
    provider's queue, the node materializes when granted, and the lease
    comes off the node exactly like the direct path; release deletes the
    queued resource (force — node included)."""
    server = TpuApiFakeServer(hosts_per_node=2).start()
    server.qr_active_after_polls = 3          # a few WAITING polls first
    try:
        prov = _prov(_api(server), queued=True,
                     channel_factory=localsim_channel_factory(
                         str(tmp_path / "hosts")))
        lease = prov.acquire(2)
        assert lease.slice_id in server.qrs
        assert server.qrs[lease.slice_id]["state"]["state"] == "ACTIVE"
        node = server.nodes[lease.slice_id]
        assert node["state"] == "READY"
        assert len(lease.hosts) == 2
        # plain on-demand: NEITHER tier field (guaranteed would mean
        # reservation capacity; schedulingConfig is rejected in QR specs)
        qr = server.qrs[lease.slice_id]
        assert "guaranteed" not in qr and "spot" not in qr
        assert "schedulingConfig" not in \
            (qr["tpu"]["nodeSpec"][0].get("node") or {}) or \
            not qr["tpu"]["nodeSpec"][0]["node"].get("schedulingConfig")
        prov.release(lease)
        assert lease.slice_id not in server.qrs
        assert lease.slice_id not in server.nodes
    finally:
        server.stop()


def test_queued_resource_spot_tier():
    server = TpuApiFakeServer().start()
    try:
        prov = _prov(_api(server), queued=True, spot=True,
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        qr = server.qrs[lease.slice_id]
        assert "spot" in qr
        assert not (qr["tpu"]["nodeSpec"][0].get("node") or {}).get(
            "schedulingConfig")
        prov.release(lease)
    finally:
        server.stop()


def test_queued_resource_survives_create_visibility_lag():
    """Right after create the QR may not be GETtable (the create LRO is
    still materializing it): a 404 within the deadline is 'not visible
    yet', never 'gone' — aborting there would force-delete a request
    that was about to succeed."""
    server = TpuApiFakeServer().start()
    server.qr_invisible_gets = 2
    try:
        prov = _prov(_api(server), queued=True,
                     channel_factory=lambda hid, ep: _localsim(hid))
        lease = prov.acquire(1)
        assert server.qrs[lease.slice_id]["state"]["state"] == "ACTIVE"
        prov.release(lease)
    finally:
        server.stop()


def test_queued_resource_no_grant_within_budget_cleans_up():
    """A request the queue never grants must fail the acquire within
    tony.gcloud.create-timeout-s AND delete the queued resource — a
    forgotten WAITING request would eventually grant and bill a node
    nobody is using."""
    server = TpuApiFakeServer().start()
    server.qr_stuck_waiting = True
    try:
        prov = _prov(_api(server), queued=True, create_timeout_s=0.3,
                     poll_interval_s=0.02)
        with pytest.raises(SliceProvisionError,
                           match="no capacity granted"):
            prov.acquire(1)
        assert server.qrs == {}
        assert server.nodes == {}
    finally:
        server.stop()


def test_gcloud_gc_reaps_only_labeled_nodes(capsys):
    """`tony-tpu gcloud-gc`: a hard-crashed coordinator can strand a
    billing node (no YARN RM to reap it) — the janitor lists
    tony-managed nodes ACROSS list pages and, with --delete, removes
    them, NEVER touching unlabeled nodes."""
    from tony_tpu_torch.cli.main import main as cli_main

    # page_size=1 forces nextPageToken pagination: a client that reads
    # only page 1 would miss the leaked node entirely.
    server = TpuApiFakeServer(page_size=1).start()
    try:
        # a leaked tony node + someone else's node in the same zone
        server.nodes["tony-dead00"] = {
            "name": "projects/p/locations/z/nodes/tony-dead00",
            "state": "READY", "acceleratorType": "v5litepod-8",
            "labels": {"tony-managed": "true", "tony-nonce": "x"},
            "networkEndpoints": []}
        server.nodes["someone-else"] = {
            "name": "projects/p/locations/z/nodes/someone-else",
            "state": "READY", "acceleratorType": "v5litepod-8",
            "labels": {}, "networkEndpoints": []}
        # list-only first: nothing deleted
        rc = cli_main(["gcloud-gc", "--project", "p", "--zone", "z",
                       "--api-endpoint", server.endpoint])
        assert rc == 0
        out = capsys.readouterr().out
        assert "tony-dead00" in out and "someone-else" not in out
        assert "tony-dead00" in server.nodes
        # --delete reaps the labeled node only
        rc = cli_main(["gcloud-gc", "--project", "p", "--zone", "z",
                       "--api-endpoint", server.endpoint, "--delete",
                       "--poll-interval", "0.05"])
        assert rc == 0
        assert "tony-dead00" not in server.nodes
        assert "someone-else" in server.nodes
    finally:
        server.stop()


def test_gcloud_gc_reaps_queued_resources_and_their_nodes(capsys):
    """The queued path's leak shapes: a WAITING request with no node yet
    (would grant and bill later), and a GRANTED one whose node the API
    only lets you delete THROUGH the queued resource."""
    from tony_tpu_torch.cli.main import main as cli_main

    server = TpuApiFakeServer(page_size=1).start()
    server.qr_active_after_polls = 1
    try:
        spec = lambda nid: {"tpu": {"nodeSpec": [{  # noqa: E731
            "parent": "projects/p/locations/z", "nodeId": nid,
            "node": {"labels": {"tony-managed": "true"}}}]},
            "guaranteed": {}}
        # leaked WAITING request (no node exists yet)
        server.qrs["tony-wait00"] = {
            "name": "projects/p/locations/z/queuedResources/tony-wait00",
            "state": {"state": "WAITING_FOR_RESOURCES"},
            **spec("tony-wait00"), "_parent": "projects/p/locations/z"}
        # leaked GRANTED request: QR ACTIVE and its node exists,
        # deletable only via the QR
        server.qrs["tony-run00"] = {
            "name": "projects/p/locations/z/queuedResources/tony-run00",
            "state": {"state": "ACTIVE"},
            **spec("tony-run00"), "_parent": "projects/p/locations/z"}
        server._materialize_node(
            "projects/p/locations/z", "tony-run00",
            {"labels": {"tony-managed": "true"}}, state="READY",
            via_qr=server.qrs["tony-run00"]["name"])
        rc = cli_main(["gcloud-gc", "--project", "p", "--zone", "z",
                       "--api-endpoint", server.endpoint, "--delete",
                       "--poll-interval", "0.05"])
        assert rc == 0
        capsys.readouterr()
        assert server.qrs == {}
        assert "tony-run00" not in server.nodes
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# Preemption: API state is lease health
# ---------------------------------------------------------------------------
def test_preempted_state_marks_all_hosts_lost(tmp_path):
    server = TpuApiFakeServer(hosts_per_node=2).start()
    try:
        prov = _prov(_api(server),
                     channel_factory=localsim_channel_factory(
                         str(tmp_path / "hosts")),
                     poll_interval_s=0.0)
        lease = prov.acquire(2)
        assert lease.lost_hosts() == []
        server.preempt(lease.slice_id)
        lease.check()
        assert lease.terminal_state == "PREEMPTED"
        assert lease.lost_hosts() == lease.hosts
        # the normal re-lease path: release deletes the preempted node,
        # a fresh acquire creates a NEW one
        prov.release(lease)
        lease2 = prov.acquire(2)
        assert lease2.slice_id != lease.slice_id
        assert server.deleted_names == [lease.slice_id]
        prov.release(lease2)
    finally:
        server.stop()


def test_api_hiccup_is_not_host_loss(tmp_path):
    """A transient API failure during the health check must NOT kill the
    gang — only a positive terminal state (or dead channels) may."""
    server = TpuApiFakeServer().start()
    try:
        prov = _prov(_api(server, retries=0),
                     channel_factory=localsim_channel_factory(
                         str(tmp_path / "hosts")),
                     poll_interval_s=0.0)
        lease = prov.acquire(1)
        server.fail_first_n = 5
        lease.check()
        assert lease.terminal_state is None
        assert lease.lost_hosts() == []
        server.fail_first_n = 0
        prov.release(lease)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The composed flagship: spot reclaim → node re-created → job resumes
# ---------------------------------------------------------------------------
def test_e2e_gcloud_preemption_recreates_node_and_resumes(tmp_path):
    """The full self-provisioned story in one flow: the COORDINATOR
    creates a TPU node via the (fake) API, runs the gang on it, the cloud
    preempts the node once the first checkpoint is durable, the broken
    lease releases (deleting the node), a FRESH node is created, and the
    retried epoch resumes from the checkpoint. No operator, no
    pre-provisioned host list — the reference's RM loop
    (ApplicationMaster.java:1051-1070) fully re-designed as code."""
    server = TpuApiFakeServer(
        hosts_per_node=1,
        preempt_when_path_exists=str(tmp_path / "ckpt" / "1" /
                                     MANIFEST_NAME)).start()
    result = tmp_path / "result.txt"
    try:
        conf = make_conf(
            tmp_path, _script(tmp_path, "train_with_resume.py",
                              RESUME_SCRIPT), workers=1,
            extra={K.APPLICATION_RETRY_COUNT: 2,
                   K.APPLICATION_CHECKPOINT_DIR: str(tmp_path / "ckpt"),
                   K.TASK_REGISTRATION_TIMEOUT_S: 60})
        conf.set(K.APPLICATION_BACKEND, "gpu-host")
        conf.set(K.SLICE_PROVISIONER, "gcloud")
        conf.set(K.SLICE_NUM_HOSTS, 1)
        conf.set(K.GCLOUD_PROJECT, "proj")
        conf.set(K.GCLOUD_ZONE, "us-central2-b")
        conf.set(K.GCLOUD_ACCELERATOR_TYPE, "v5litepod-8")
        conf.set(K.GCLOUD_CHANNEL, "localsim")
        conf.set(K.GCLOUD_API_ENDPOINT, server.endpoint)
        conf.set(K.GCLOUD_POLL_INTERVAL_S, 0.1)
        conf.set(K.GCLOUD_SPOT, True)
        conf.set(K.EXECUTION_ENV, f"TONY_TEST_RESULT={result}")
        conf.set(K.EXECUTION_ENV, "TONY_TEST_STEPS=4")
        conf.set(K.EXECUTION_ENV, "TONY_TEST_STEP_SLEEP=0.2")
        client, rec, code = submit(conf, tmp_path)
        assert code == 0, _dump_task_logs(client)
        assert rec.finished[0] == "SUCCEEDED"
        assert int(rec.finished[1].get("attempt", 0)) >= 1    # retried
        start, end, w1 = result.read_text().split()
        assert int(start) >= 1, \
            f"retried epoch should RESUME (start >= 1), got {start}"
        assert int(end) == 4
        assert float(w1) == 2.0 ** 4
        # the node lifecycle really happened through the API: the
        # preempted node was deleted and a fresh one created
        assert server.create_count >= 2
        assert len(server.created_names) >= 2
        assert server.created_names[0] in server.deleted_names
        # nothing strands: the reclaimed-host task tree is reaped
        from procwatch import assert_no_orphans
        assert_no_orphans(f"TONY_APP_ID={rec.app_id}")
    finally:
        server.stop()


def test_gcloud_gc_reaps_node_with_stale_queued_resource(capsys):
    """A leak shape: a node whose queuedResource record no longer
    exists (externally deleted QR / partial force-delete) matched neither
    the node path (it carries a QR ref) nor the QR path (its QR is gone)
    — the janitor must list it as stale and still reap it."""
    from tony_tpu_torch.cli.main import main as cli_main

    server = TpuApiFakeServer().start()
    try:
        server._materialize_node(
            "projects/p/locations/z", "tony-stale00",
            {"labels": {"tony-managed": "true"}}, state="READY",
            via_qr="projects/p/locations/z/queuedResources/tony-stale00")
        # the QR record is GONE; only the node + its dangling ref remain
        assert "tony-stale00" not in server.qrs
        rc = cli_main(["gcloud-gc", "--project", "p", "--zone", "z",
                       "--api-endpoint", server.endpoint])
        assert rc == 0
        out = capsys.readouterr().out
        assert "tony-stale00" in out and "stale queued-resource" in out
        rc = cli_main(["gcloud-gc", "--project", "p", "--zone", "z",
                       "--api-endpoint", server.endpoint, "--delete",
                       "--poll-interval", "0.05"])
        assert rc == 0
        assert "tony-stale00" not in server.nodes
    finally:
        server.stop()
