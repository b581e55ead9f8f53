"""Port parity: telemetry.py and profiler.py of tony_tpu_torch against
tony_tpu's, and the port's copies of the modules they lean on (faults,
retry, constants, conf keys, utils.durable).

The step and phase accounting must agree exactly: both modules run one
scripted sequence of step/phase calls under the same fake clock, and
phase_stats() and step_stats() come out equal."""

import json
import os

import pytest
import torch

from tony_tpu import constants as jconst
from tony_tpu import faults as jfaults
from tony_tpu import retry as jretry
from tony_tpu import telemetry as jtel
from tony_tpu_torch import constants, faults, profiler, retry, telemetry
from tony_tpu_torch.utils import durable


class _FakeTime:
    """A clock the test moves by hand; time.time() is fixed."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1.7e9

    def sleep(self, s):
        self.now += s


def _reset(mod):
    mod._reset_phase_state()
    mod._reset_profile_state()
    mod._steps.update(count=0, busy_s=0.0, flops=0.0, tokens=0.0,
                      first_start=0.0, last_end=0.0, first_end_wall=0.0)


@pytest.fixture
def both(monkeypatch):
    """The reference and the port telemetry, each on its own fake clock,
    reset before and after."""
    mods = (jtel, telemetry)
    for mod in mods:
        monkeypatch.setattr(mod, "time", _FakeTime())
        _reset(mod)
    jfaults.uninstall()
    faults.uninstall()
    yield mods
    for mod in mods:
        _reset(mod)


def _script(mod):
    """Steps with data waits, comms, an explicit step_compute, a
    checkpoint stall between steps and an idle gap."""
    clock = mod.time
    for i in range(12):
        with mod.step(flops=1e12 * (i + 1), tokens=4096):
            with mod.phase("data_wait"):
                clock.now += 0.001 * (i % 3)
            clock.now += 0.05
            if i % 2:
                with mod.phase("comms") as p:
                    clock.now += 0.01
                    p.block_until_ready(None)
            if i == 5:
                with mod.phase("step_compute"):
                    clock.now += 0.07
        if i in (3, 7):
            with mod.phase("ckpt_stall"):
                clock.now += 0.2
        clock.now += 0.003


def test_scripted_step_and_phase_stats_equal_reference(both):
    for mod in both:
        _script(mod)
    ref, ours = both
    assert ours.phase_stats() == ref.phase_stats()
    assert ours.step_stats() == ref.step_stats()
    stats = ours.phase_stats()
    assert stats["steps"] == 12.0
    assert abs(sum(stats["cum"].values()) - stats["wall_s"]) < 1e-9


def test_phase_ring_size_matches(both):
    assert telemetry._phase_ring.maxlen == jtel._phase_ring.maxlen
    assert telemetry.PHASES == jtel.PHASES
    assert telemetry.OTHER_PHASE == jtel.OTHER_PHASE


def test_collect_device_stats_on_cpu_has_steps_and_no_device_keys(both):
    _script(telemetry)
    stats = telemetry.collect_device_stats()
    for key in ("steps_completed", "steps_per_sec", "mean_step_s",
                "step_duty_cycle", "tokens_per_sec", "model_flops_per_sec",
                "step_phases"):
        assert key in stats, key
    for key in ("device_count", "hbm_bytes_in_use", "hbm_peak_bytes",
                "devices", "mfu_vs_peak_bf16"):
        assert key not in stats, key


def test_block_until_ready_passes_cpu_tensors_through():
    x = {"a": torch.ones(3), "b": [torch.zeros(2), 1.5]}
    with telemetry.phase("comms") as p:
        assert p.block_until_ready(x) is x
    telemetry._reset_phase_state()


def test_user_fault_sites_on_step_done(both):
    faults.install(faults.FaultInjector({"user.hang": "first:1",
                                         "user.slow_step": "at:2,amt:0.5"}))
    try:
        clock = telemetry.time
        for _ in range(3):
            with telemetry.step():
                clock.now += 0.1
    finally:
        faults.uninstall()
    s = telemetry.step_stats()
    # the first step was dropped (hang); the second slept 0.5 s more
    assert s["steps_completed"] == 2.0
    assert s["mean_step_s"] == pytest.approx((0.6 + 0.1) / 2)


def test_write_and_read_stats_roundtrip(tmp_path, both):
    path = str(tmp_path / "m.json")
    assert not telemetry.write_stats_once(path)     # nothing to say yet
    _script(telemetry)
    assert telemetry.write_stats_once(path)
    stats = telemetry.read_stats(path)
    assert stats["steps_completed"] == 12.0
    assert stats["pid"] == os.getpid()
    assert telemetry.read_stats(str(tmp_path / "missing.json")) == {}


def test_maybe_start_requires_env(monkeypatch):
    monkeypatch.delenv("TONY_METRICS_FILE", raising=False)
    assert not telemetry.maybe_start()


def test_stack_dump_handler_needs_env(monkeypatch):
    monkeypatch.delenv("TONY_STACKDUMP_SIGNAL", raising=False)
    assert not telemetry.install_stack_dump_handler()


def test_on_demand_profile_capture(tmp_path, both):
    """A request file arms torch.profiler at the next step boundary and
    the boundary after its last step exports the Chrome trace."""
    req = tmp_path / "req.json"
    dest = tmp_path / "prof"
    req.write_text(json.dumps({"id": 3, "steps": 1, "dir": str(dest)}))
    telemetry._poll_profile_request(str(req))
    telemetry._poll_profile_request(str(req))        # same id: no-op
    with telemetry.step():
        pass                                         # arms at its end
    assert telemetry.profile_state()["status"] == "active"
    with telemetry.step():
        torch.ones(8).sum()
    state = telemetry.profile_state()
    assert state["status"] == "captured" and state["dir"] == str(dest)
    with open(dest / profiler.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)


def test_on_demand_profile_capture_fault_degrades(tmp_path, both):
    req = tmp_path / "req.json"
    req.write_text(json.dumps({"id": 1, "steps": 2,
                               "dir": str(tmp_path / "p")}))
    faults.install(faults.FaultInjector({"profile.capture": "first:1"}))
    try:
        telemetry._poll_profile_request(str(req))
        with telemetry.step():
            pass
    finally:
        faults.uninstall()
    state = telemetry.profile_state()
    assert state["status"] == "failed" and "injected" in state["error"]


def test_trace_window_noop_when_unset(monkeypatch):
    monkeypatch.delenv("TONY_PROFILE_DIR", raising=False)
    assert profiler.profile_dir() is None
    with profiler.trace_window() as out:
        assert out is None


def test_trace_window_writes_a_trace_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("TONY_PROFILE_DIR", str(tmp_path))
    with profiler.trace_window("steps") as out:
        (torch.randn(16, 16) @ torch.randn(16, 16)).sum()
    assert out == str(tmp_path / "steps")
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_constants_match_reference():
    for name in ("METRICS_FILE", "TELEMETRY_INTERVAL_ENV",
                 "STACKDUMP_SIGNAL", "PROFILE_DIR", "PROFILE_REQUEST_ENV"):
        assert getattr(constants, name) == getattr(jconst, name), name
    assert profiler.PROFILE_DIR_ENV == "TONY_PROFILE_DIR"


def test_fault_sites_and_specs_match_reference():
    assert faults.SITES == jfaults.SITES
    spec = "seed=7;rpc.send=first:2;storage.get=p:0.3,session:0"
    a, b = jfaults.parse_spec(spec), faults.parse_spec(spec)
    assert a.to_env_value() == b.to_env_value()
    # the same deterministic decision sequence per site
    for site in ("rpc.send", "storage.get"):
        assert [a.fire(site) for _ in range(20)] == \
            [b.fire(site) for _ in range(20)]


def test_install_from_conf_reads_port_keys():
    from tony_tpu.conf.config import TonyTpuConfig
    from tony_tpu_torch.conf import keys as K

    conf = TonyTpuConfig()
    conf.set(K.FAULT_SEED, 5)
    conf.set(K.fault_key("ckpt.async-write"), "first:1")
    try:
        assert faults.install_from_conf(conf)
        inj = faults.active()
        assert inj.seed == 5 and set(inj.rules) == {"ckpt.async-write"}
    finally:
        faults.uninstall()
    assert not faults.install_from_conf(TonyTpuConfig())


def test_retry_policy_matches_reference():
    import random

    for jitter in (False, True):
        p = retry.RetryPolicy(max_attempts=4, base_delay_s=0.1,
                              max_delay_s=0.5, jitter=jitter)
        q = jretry.RetryPolicy(max_attempts=4, base_delay_s=0.1,
                               max_delay_s=0.5, jitter=jitter)
        assert [p.delay_s(i, random.Random(1)) for i in range(5)] == \
            [q.delay_s(i, random.Random(1)) for i in range(5)]
    slept = []
    calls = iter([OSError("reset"), OSError("reset"), "ok"])

    def flaky():
        v = next(calls)
        if isinstance(v, Exception):
            raise v
        return v

    assert retry.call_with_retry(flaky, retry.RetryPolicy(jitter=False),
                                 sleep=slept.append) == "ok"
    assert slept == [0.5, 1.0]


def test_atomic_write_and_torn_rename_fault(tmp_path):
    path = str(tmp_path / "f.json")
    durable.atomic_write(path, b"one")
    faults.install(faults.FaultInjector({"disk.torn": "first:1"}))
    try:
        with pytest.raises(OSError):
            durable.atomic_write(path, b"two")
    finally:
        faults.uninstall()
    assert open(path, "rb").read() == b"one"       # the old bytes survive
    assert os.listdir(tmp_path) == ["f.json"]      # no temp file left
