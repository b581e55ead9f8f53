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


#: The ROADMAP item that brings the backends other than ``local``.
GPU_HOST_BACKEND_ITEM = (
    "ROADMAP A11b, the GPU host backend (the counterpart of "
    "cluster/tpu.py's TpuSliceBackend and of cluster/gcloud.py)")


def _make_backend(conf, workdir):
    """Backend selection (tony.application.backend): local subprocesses.
    The reference's ``tpu-slice`` (with its fake, ssh and gcloud
    provisioners) has no GPU counterpart yet, so any other value raises."""
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
    raise ValueError(
        f"tony.application.backend {kind!r} is not in the port: 'local' "
        f"is its only backend; {GPU_HOST_BACKEND_ITEM} comes next")


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
