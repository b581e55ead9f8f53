"""Jobs through the port's control plane for the observer tests
(``test_torch_portal.py``, ``test_torch_observability.py``,
``test_torch_alerts.py``, ``test_torch_profiling.py``,
``test_torch_notebook.py``): ``tests/test_e2e.py``'s ``make_conf`` and
``submit`` with framework ``pytorch`` and the user script written into
``tmp_path`` from its text."""

import sys
import time

from tony_tpu_torch.client import TaskUpdateListener, TonyTpuClient
from tony_tpu_torch.conf import keys as K
from tony_tpu_torch.conf.config import TonyTpuConfig

#: ``tests/scripts/train_phases.py`` on the port: a torch loop fed through
#: the port's ``ShardedBatchIterator`` (so ``data_wait`` comes from the
#: production data.py wiring), ``step_compute`` anchored on the result.
#: ``TONY_TEST_DATA_STALL_S`` injects a per-step input stall,
#: ``TONY_TEST_STEPS`` bounds the run.
PHASES_SCRIPT = r"""
import os
import time

import numpy as np
import torch

import tony_tpu_torch  # noqa: F401  (starts the reporter + arms TONY_FAULTS)
from tony_tpu_torch import telemetry
from tony_tpu_torch.data import ShardedBatchIterator

torch.set_num_threads(1)
stall = float(os.environ.get("TONY_TEST_DATA_STALL_S", "0") or 0)


def load_local(step, rows):
    if stall:
        time.sleep(stall)
    return {"x": np.full((rows.stop - rows.start, 4), float(step),
                         np.float32)}


it = ShardedBatchIterator(global_batch=8, load_local=load_local,
                          prefetch=0, device="cpu", rank=0, world=1)
steps = int(os.environ.get("TONY_TEST_STEPS", "200"))
for _ in range(steps):
    batch = next(it)
    with telemetry.step():
        with telemetry.phase("step_compute") as p:
            y = (batch["x"] * 2.0).sum()
            p.block_until_ready(y)
it.close()
telemetry.write_stats_once(os.environ.get("TONY_METRICS_FILE", ""))
"""


class Recorder(TaskUpdateListener):
    def __init__(self):
        self.app_id = None
        self.finished = None

    def on_application_id_received(self, app_id):
        self.app_id = app_id

    def on_application_finished(self, status, report):
        self.finished = (status, report)


def make_conf(tmp_path, name, text, workers=2, extra=None):
    path = tmp_path / name
    path.write_text(text)
    conf = TonyTpuConfig()
    conf.set("tony.worker.instances", workers)
    conf.set("tony.worker.command", f"{sys.executable} {path}")
    conf.set(K.APPLICATION_FRAMEWORK, "pytorch")
    conf.set(K.TASK_REGISTRATION_TIMEOUT_S, 60)
    conf.set(K.APPLICATION_TIMEOUT_S, 120)
    conf.set(K.HISTORY_LOCATION, str(tmp_path / "history"))
    conf.set(K.CLIENT_POLL_INTERVAL_MS, 100)
    conf.set(K.COORDINATOR_MONITOR_INTERVAL_MS, 100)
    for k, v in (extra or {}).items():
        conf.set(k, v)
    return conf


def submit(conf, tmp_path):
    client = TonyTpuClient(conf, workdir=str(tmp_path / "work"))
    rec = Recorder()
    client.add_listener(rec)
    code = client.start()
    return client, rec, code


def wait_for(pred, timeout_s=60, interval_s=0.2, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval_s)
    raise AssertionError(f"timed out waiting for {what}")

#: ``tests/scripts/steps_for.py`` on the port: TONY_TEST_STEPS
#: telemetry-instrumented steps of 20 ms.
STEPS_FOR_SCRIPT = r"""
import os
import time

import tony_tpu_torch  # noqa: F401  (starts the reporter + arms TONY_FAULTS)
from tony_tpu_torch import telemetry

for _ in range(int(os.environ.get("TONY_TEST_STEPS", "100"))):
    with telemetry.step():
        time.sleep(0.02)
"""

EXIT_0_SCRIPT = "import sys\nsys.exit(0)\n"
