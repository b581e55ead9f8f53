"""Port parity: the control plane of tony_tpu_torch against tony_tpu's on the
same inputs.

The port keeps the reference's names and wire formats: configuration keys,
the frozen config artifact, every runtime's environment, RPC frames and
their HMAC, event lines and history file names, and the exit-code decoders.
Each test feeds both packages the same inputs and compares what comes out.
"""

import json
import os

import pytest

from tony_tpu.conf import keys as jkeys
from tony_tpu.conf.config import TonyTpuConfig as JConfig
from tony_tpu.coordinator import session as jsession
from tony_tpu.diagnosis import exitcodes as jexit
from tony_tpu.events import events as jevents
from tony_tpu.events import history as jhistory
from tony_tpu.rpc import wire as jwire
from tony_tpu.runtimes import base as jruntimes
from tony_tpu_torch import constants
from tony_tpu_torch.conf import keys
from tony_tpu_torch.conf.config import TonyTpuConfig
from tony_tpu_torch.coordinator import session
from tony_tpu_torch.diagnosis import exitcodes
from tony_tpu_torch.events import events, history
from tony_tpu_torch.rpc import wire
from tony_tpu_torch.runtimes import base as runtimes

#: Keys whose default the port changes on purpose: (reference, port).
PORT_DEFAULTS = {keys.APPLICATION_FRAMEWORK: ("jax", "pytorch"),
                 keys.POOL_PRELOAD: ("jax", "torch")}

#: Cluster specs: one host; two hosts; a chief plus workers over two hosts.
SPECS = {
    "one_host": {"worker": ["h0:2000", "h0:2001", "h0:2002"]},
    "two_hosts": {"worker": ["h0:2000", "h0:2001", "h1:2000", "h1:2001"]},
    "chief_workers": {"chief": ["h0:3000"],
                      "worker": ["h0:3001", "h1:3000", "h1:3001"],
                      "ps": ["h2:4000"]},
}
#: The pytorch runtime's LOCAL_RANK / LOCAL_WORLD_SIZE per task: its place
#: among the tasks on its host in the global order, and their count.
LOCAL = {
    "one_host": {"worker:0": (0, 3), "worker:1": (1, 3),
                 "worker:2": (2, 3)},
    "two_hosts": {"worker:0": (0, 2), "worker:1": (1, 2),
                  "worker:2": (0, 2), "worker:3": (1, 2)},
    "chief_workers": {"chief:0": (0, 2), "worker:0": (1, 2),
                      "worker:1": (0, 2), "worker:2": (1, 2),
                      "ps:0": (0, 1)},
}
RUNTIMES = ("generic", "jax", "tensorflow", "pytorch", "horovod")


def test_key_registry_matches_reference():
    mine, ref = keys.registry(), jkeys.registry()
    assert sorted(mine) == sorted(ref)
    for name, k in ref.items():
        p = mine[name]
        assert (p.name, p.type, p.multi_value) == \
            (k.name, k.type, k.multi_value), name
        want = PORT_DEFAULTS.get(name, (k.default, k.default))
        assert (k.default, p.default) == want, name
    for fmt in ("INSTANCES_FORMAT", "COMMAND_FORMAT", "CHIPS_FORMAT",
                "ENV_FORMAT", "DOCKER_IMAGE_FORMAT"):
        assert getattr(keys, fmt) == getattr(jkeys, fmt)
    for name in ("tony.worker.instances", "tony.chief.command",
                 "tony.application.instances", "tony.ps.depends-on"):
        assert keys.parse_job_key(name) == jkeys.parse_job_key(name)


def test_port_defaults_file_is_generated():
    """``tony_tpu_torch/conf/defaults.md`` is ``python -m
    tony_tpu_torch.conf.keys``'s output, as the reference's is its own."""
    path = os.path.join(os.path.dirname(keys.__file__), "defaults.md")
    with open(path, encoding="utf-8") as f:
        assert f.read() == keys.defaults_markdown()


def _layers(tmp_path):
    conf_file = tmp_path / "job.json"
    conf_file.write_text(json.dumps({
        "tony": {"worker": {"instances": 3, "command": "python train.py"},
                 "ps": {"instances": 1, "memory": "4g"},
                 "application": {"name": "parity", "timeout-s": "600"},
                 "containers": {"resources": "data.txt"}}}))
    (tmp_path / "data.txt").write_text("x\n")
    return str(conf_file), ("tony.worker.chips=4",
                            "tony.containers.resources=extra.zip",
                            "tony.task.heartbeat-interval-ms=250")


def test_layered_config_freezes_to_the_same_artifact(tmp_path,
                                                     monkeypatch):
    monkeypatch.delenv("TONY_TPU_CONF_DIR", raising=False)
    conf_file, overrides = _layers(tmp_path)
    mine = TonyTpuConfig.from_layers(conf_file, overrides)
    ref = JConfig.from_layers(conf_file, overrides)
    # The framework is set by the job, and the pool's preload by its
    # operator (the two defaults the port changes, PORT_DEFAULTS), so the
    # artifacts differ nowhere.
    for c in (mine, ref):
        c.set(keys.APPLICATION_FRAMEWORK, "pytorch")
        c.set(keys.POOL_PRELOAD, "torch")
    a = json.loads(open(mine.freeze(str(tmp_path / "port.json"))).read())
    b = json.loads(open(ref.freeze(str(tmp_path / "ref.json"))).read())
    assert a == b
    assert a["tony.containers.resources"] == ref.get(
        "tony.containers.resources")
    assert {n: (j.instances, j.chips, j.memory)
            for n, j in mine.job_types().items()} == \
        {n: (j.instances, j.chips, j.memory)
         for n, j in ref.job_types().items()}
    back = TonyTpuConfig.load_final(str(tmp_path / "ref.json"))
    assert back.as_dict() == ref.as_dict()


def _identities(spec):
    flat = runtimes.flatten_spec(spec)
    assert flat == jruntimes.flatten_spec(spec)
    for task in flat:
        job, _, idx = task.partition(":")
        port = int(spec[job][int(idx)].rpartition(":")[2])
        yield task, (job, int(idx), len(flat), job == "chief", port)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("framework", RUNTIMES)
def test_runtime_env_matches_reference(spec_name, framework):
    spec = SPECS[spec_name]
    conf, jconf = TonyTpuConfig(), JConfig()
    for c in (conf, jconf):
        c.set(keys.JAX_COMPILE_CACHE_DIR, "")
    for task, ident in _identities(spec):
        env = runtimes.get_runtime(framework).build_env(
            spec, runtimes.TaskIdentity(*ident), conf)
        ref = jruntimes.get_runtime(framework).build_env(
            spec, jruntimes.TaskIdentity(*ident), jconf)
        if framework == "pytorch":
            local = (int(env.pop(constants.LOCAL_RANK)),
                     int(env.pop(constants.LOCAL_WORLD_SIZE)))
            assert local == LOCAL[spec_name][task], task
        assert env == ref, task


class _Service:
    def add(self, a, b):
        return a + b

    def echo(self, value):
        return value


@pytest.mark.parametrize("direction", ["port_client_ref_server",
                                       "ref_client_port_server"])
def test_rpc_across_packages(direction):
    """Framing and the HMAC must agree byte for byte: a job token signs
    every frame both ways, and a wrong token is refused."""
    server_mod, client_mod = (jwire, wire) if \
        direction == "port_client_ref_server" else (wire, jwire)
    srv = server_mod.RpcServer(_Service(), port=0, token="job-token")
    srv.start()
    try:
        c = client_mod.RpcClient("127.0.0.1", srv.port, token="job-token",
                                 max_retries=2, retry_sleep_s=0.05)
        try:
            assert c.call("add", a=2, b=40) == 42
            payload = {"spec": {"worker": ["h:1", "h:2"]}, "n": [1, 2.5]}
            assert c.call("echo", value=payload) == payload
        finally:
            c.close()
        bad = client_mod.RpcClient("127.0.0.1", srv.port, token="wrong",
                                   max_retries=1, retry_sleep_s=0.05)
        try:
            with pytest.raises(client_mod.RpcError):
                bad.call("add", a=1, b=1)
        finally:
            bad.close()
    finally:
        srv.stop()


def _event_pairs():
    payloads = [
        ("APPLICATION_INITED", {"app_id": "app_1", "num_tasks": 2,
                                "user": "u"}),
        ("TASK_STARTED", {"task": "worker:0", "host": "h0"}),
        ("TASK_FINISHED", {"task": "worker:0", "status": "SUCCEEDED",
                           "metrics": {"MAX_TPU_HBM_BYTES": 1.5e9},
                           "logs": ["a/stdout.log"]}),
        ("APPLICATION_FINISHED", {"status": "SUCCEEDED", "app_id": "app_1"}),
    ]
    return [(events.Event(events.EventType(t), dict(p), 1_760_000_000_123),
             jevents.Event(jevents.EventType(t), dict(p), 1_760_000_000_123))
            for t, p in payloads]


def test_events_and_history_names_match_reference(tmp_path):
    assert [e.value for e in events.EventType] == \
        [e.value for e in jevents.EventType]
    pairs = _event_pairs()
    for mine, ref in pairs:
        assert mine.to_json() == ref.to_json()
        assert events.Event.from_json(ref.to_json()) == mine
    assert history.in_progress_name("app_1", 17, "u") == \
        jhistory.in_progress_name("app_1", 17, "u")
    name = history.final_name("app_1", 17, 29, "u", "SUCCEEDED")
    assert name == jhistory.final_name("app_1", 17, 29, "u", "SUCCEEDED")
    assert history.parse_metadata(name).__dict__ == \
        jhistory.parse_metadata(name).__dict__
    # The port's writer's file reads back through the reference's reader.
    h = events.EventHandler(str(tmp_path), "app_1.jhist.jsonl.inprogress")
    h.start()
    for mine, _ in pairs:
        h.emit(mine)
    final = h.stop("app_1.jhist.jsonl")
    assert [e.to_json() for e in jevents.read_events(final)] == \
        [ref.to_json() for _, ref in pairs]


EXIT_CODES = [None, 0, 1, 2, 124, 130, 134, 137, 139, 143, 255, -6, -9,
              -15, 9, 300]


def test_exit_decoders_match_reference():
    for code in EXIT_CODES:
        assert exitcodes.describe_exit(code) == jexit.describe_exit(code)
        assert exitcodes.exit_signal(code) == jexit.exit_signal(code)
        if code is not None:
            for hint in (None, "PREEMPTION"):
                mine = session.classify_exit(code, hint)
                ref = jsession.classify_exit(code, hint)
                assert (mine and mine.value) == (ref and ref.value), code


@pytest.mark.parametrize("backend", ["gpu-host", "tpu-slice", "nope"])
def test_only_the_local_backend_and_no_pool(tmp_path, backend):
    """Beside ``local``, the port's one backend is ``gpu-host``
    (cluster/gpu.py, the counterpart of the reference's ``tpu-slice``):
    it builds a GpuHostBackend; the reference's value raises naming
    ``gpu-host`` instead of quietly aliasing it; any other raises. (The
    warm pool is ported: tests/test_torch_pool.py.)"""
    from tony_tpu_torch.cluster.gpu import GpuHostBackend
    from tony_tpu_torch.coordinator.__main__ import _make_backend

    conf = TonyTpuConfig()
    conf.set(keys.APPLICATION_BACKEND, backend)
    if backend == "gpu-host":
        assert isinstance(_make_backend(conf, str(tmp_path)),
                          GpuHostBackend)
        return
    with pytest.raises(ValueError, match="gpu-host" if backend ==
                       "tpu-slice" else "unknown tony.application"):
        _make_backend(conf, str(tmp_path))


def test_monitor_reads_device_memory_from_the_user_process(tmp_path):
    """The executor's monitor takes device memory from the user process's
    telemetry file, as the reference's does, and folds the process's own
    peak into the maximum; it never imports torch for it."""
    from tony_tpu.executor import monitor as jmonitor
    from tony_tpu_torch.executor import monitor

    path = tmp_path / "metrics.json"
    mine = monitor.TaskMonitor("worker:0", lambda *_: None,
                               metrics_file=str(path))
    ref = jmonitor.TaskMonitor("worker:0", lambda *_: None,
                               metrics_file=str(path))
    for in_use, peak in ((2e9, 3e9), (1e9, 5e9)):
        path.write_text(json.dumps({"hbm_bytes_in_use": in_use,
                                    "hbm_peak_bytes": peak,
                                    "device_count": 1.0,
                                    "steps_completed": 4.0}))
        a, b = mine.sample_once(), ref.sample_once()
    assert a[monitor.MAX_TPU_HBM_BYTES] == 5e9
    assert b[jmonitor.MAX_TPU_HBM_BYTES] == 2e9
    for key in (monitor.AVG_TPU_HBM_BYTES, monitor.USER_DEVICE_COUNT,
                monitor.STEPS_COMPLETED):
        assert a[key] == b[key], key
    # torch is imported in this process but CUDA is not up: no probe.
    assert monitor.cuda_memory_in_use_bytes() == 0
