"""Standalone coordinator process entrypoint.

The reference's ApplicationMaster runs as its own JVM in a YARN container
(``TonyClient`` builds the AM command, :710-729); here the client spawns
``python -m tony_tpu_torch.coordinator`` and discovers its RPC endpoint through an
address file in the job dir (the analogue of the RM app report carrying the
AM host:port, ``TonyClient.initRpcClientAndLogAMUrl`` :922).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from tony_tpu_torch import constants
from tony_tpu_torch.cluster.local import LocalProcessBackend
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.coordinator.coordinator import Coordinator
from tony_tpu_torch.coordinator.session import SessionStatus
from tony_tpu_torch.utils.durable import atomic_write


def _make_backend(conf, workdir):
    """Backend selection (tony.application.backend): local subprocesses or
    a leased slice of GPU hosts (cluster/gpu.py), the counterpart of the
    reference's ``tpu-slice``. The reference's value raises: a job conf
    written for TPU slices must not quietly land on GPU hosts."""
    from tony_tpu_torch.conf import keys as K

    kind = str(conf.get(K.APPLICATION_BACKEND, "local"))
    if kind == "local":
        if conf.get_bool(K.SCALE_VIRTUAL_EXECUTORS):
            # Width harness: beat-only in-process virtual executors
            # instead of real subprocesses — control-plane traffic at
            # 128–1024 tasks.
            from tony_tpu_torch.cluster.local import VirtualExecutorBackend

            return VirtualExecutorBackend.from_conf(conf, workdir)
        # With tony.pool.dir the backend adopts a warm executor
        # (tony_tpu_torch/pool.py) before cold-spawning.
        pool_dir = os.path.expanduser(
            str(conf.get(K.POOL_DIR, "") or ""))
        return LocalProcessBackend(workdir, pool_dir=pool_dir)
    if kind == "tpu-slice":
        raise ValueError(
            "tony.application.backend 'tpu-slice' is the reference's TPU "
            "backend; the port's counterpart is 'gpu-host' (cluster/gpu.py)")
    if kind == "gpu-host":
        from tony_tpu_torch.cluster.gpu import (FakeSliceProvisioner,
                                                GpuHostBackend,
                                                StaticSshProvisioner)

        n_hosts = int(conf.get(K.SLICE_NUM_HOSTS, 1))
        prov_kind = str(conf.get(K.SLICE_PROVISIONER, "fake"))
        if prov_kind == "ssh":
            targets = [t.strip()
                       for t in str(conf.get(K.SLICE_HOSTS, "")).split(",")
                       if t.strip()]
            prov = StaticSshProvisioner(
                targets,
                python=str(conf.get(K.SLICE_REMOTE_PYTHON, "python3")))
        elif prov_kind == "fake":
            inv = int(conf.get(K.SLICE_FAKE_INVENTORY, 0)) or n_hosts
            prov = FakeSliceProvisioner(inv, os.path.join(workdir, "hosts"))
        elif prov_kind == "gcloud":
            # The framework acquires its own compute via the Cloud TPU API
            # (cluster/gcloud.py), as the reference does.
            from tony_tpu_torch.cluster.gcloud import (
                GcloudTpuProvisioner, TpuApiClient, localsim_channel_factory)

            api = TpuApiClient(
                project=str(conf.get(K.GCLOUD_PROJECT, "")),
                zone=str(conf.get(K.GCLOUD_ZONE, "")),
                endpoint=str(conf.get(K.GCLOUD_API_ENDPOINT, "")) or None)
            factory = None
            if str(conf.get(K.GCLOUD_CHANNEL, "ssh")) == "localsim":
                factory = localsim_channel_factory(
                    os.path.join(workdir, "hosts"))
            prov = GcloudTpuProvisioner(
                api,
                accelerator_type=str(
                    conf.get(K.GCLOUD_ACCELERATOR_TYPE, "")),
                runtime_version=str(conf.get(K.GCLOUD_RUNTIME_VERSION, "")),
                node_prefix=str(conf.get(K.GCLOUD_NODE_PREFIX, "tony")),
                ssh_user=str(conf.get(K.GCLOUD_SSH_USER, "")),
                remote_python=str(
                    conf.get(K.SLICE_REMOTE_PYTHON, "python3")),
                create_timeout_s=float(
                    conf.get(K.GCLOUD_CREATE_TIMEOUT_S, 900)),
                poll_interval_s=float(
                    conf.get(K.GCLOUD_POLL_INTERVAL_S, 5.0)),
                spot=bool(conf.get(K.GCLOUD_SPOT, False)),
                network=str(conf.get(K.GCLOUD_NETWORK, "")),
                queued=bool(conf.get(K.GCLOUD_QUEUED_RESOURCE, False)),
                channel_factory=factory)
        else:
            raise ValueError(f"unknown tony.slice.provisioner {prov_kind!r}")
        return GpuHostBackend(prov, n_hosts, workdir)
    raise ValueError(f"unknown tony.application.backend {kind!r}")


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    p = argparse.ArgumentParser(prog="tony-tpu-coordinator")
    p.add_argument("--conf", required=True, help="frozen tony-final.json")
    p.add_argument("--conf-wait-s", type=float, default=0.0,
                   help="poll up to this many seconds for --conf to "
                        "appear before loading it. The client spawns the "
                        "coordinator BEFORE staging finishes (overlapped "
                        "submit: interpreter boot + imports + backend "
                        "construction run concurrently with the bundle "
                        "copies) and freezes the config last — atomically, "
                        "so a partial file is never visible. 0 = legacy "
                        "fail-fast when the file is missing.")
    p.add_argument("--app-id", required=True)
    p.add_argument("--history-root", required=True)
    p.add_argument("--workdir", required=True,
                   help="task working directories root")
    p.add_argument("--addr-file", required=True,
                   help="file to write 'host port token' for the client")
    p.add_argument("--user", default="")
    p.add_argument("--recover", action="store_true",
                   help="replay the job's write-ahead session journal and "
                        "resume the surviving gang at its current epoch "
                        "instead of launching a fresh one (coordinator "
                        "crash recovery; see docs/operations.md)")
    args = p.parse_args(argv)

    if args.conf_wait_s > 0 and not os.path.exists(args.conf):
        from tony_tpu_torch.utils import proc as procutil

        found = procutil.poll_till_non_null(
            lambda: os.path.exists(args.conf) or None,
            interval_s=0.05, timeout_s=args.conf_wait_s)
        if found is None:
            logging.getLogger(__name__).error(
                "frozen config %s never appeared within %.0fs — the "
                "client died mid-staging?", args.conf, args.conf_wait_s)
            return constants.EXIT_FAILURE
    conf = TonyTpuConfig.load_final(args.conf)
    backend = _make_backend(conf, args.workdir)
    try:
        coord = Coordinator(conf, args.app_id, backend, args.history_root,
                            user=args.user, recover=args.recover,
                            addr_file=args.addr_file)
    except Exception as e:  # noqa: BLE001 — e.g. JournalError on --recover
        logging.getLogger(__name__).error("coordinator startup failed: %s", e)
        return constants.EXIT_FAILURE
    host, port = "", 0

    # Start RPC before writing the address file so the client never dials a
    # dead endpoint; Coordinator.run() starts it too (idempotent).
    coord.rpc.start()
    host, port = coord.rpc.address
    # The file carries the RPC auth token: it must be 0600 from its very
    # first byte (atomic_write's mode applies to the temp file, no
    # chmod-after window), and executors re-resolve it during
    # coordinator-loss recovery — a torn addr file would strand them.
    atomic_write(args.addr_file,
                 json.dumps({"host": host, "port": port,
                             "token": coord.rpc_token or "",
                             "tls_cert": coord.tls_cert}).encode("utf-8"),
                 mode=0o600)

    status = coord.run()
    return 0 if status == SessionStatus.SUCCEEDED else constants.EXIT_FAILURE


if __name__ == "__main__":
    sys.exit(main())
