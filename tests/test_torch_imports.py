"""The port stands alone: no file of tony_tpu_torch/ and not chip_smoke.py
imports jax, flax, optax or tony_tpu, or names a module of tony_tpu in a
string (a ``-m`` argument spawns that module); importing the package leaves
jax out of sys.modules, and the control plane's entry modules import without
torch."""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tony_tpu")
# A dotted module name of the reference, as in "-m", "tony_tpu.executor".
REFERENCE_MODULE = re.compile(r"\btony_tpu\.[A-Za-z_]")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, files in os.walk(
            os.path.join(REPO, "tony_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "_build")]
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_found():
    files = _port_files()
    assert len(files) >= 10
    assert any(f.endswith("attention.py") for f in files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import tony_tpu_torch, tony_tpu_torch.ops, tony_tpu_torch.models\n"
        "import tony_tpu_torch.parallel, tony_tpu_torch.data\n"
        "import tony_tpu_torch.convert, tony_tpu_torch.trainer\n"
        "import tony_tpu_torch.telemetry, tony_tpu_torch.profiler\n"
        "import tony_tpu_torch.faults, tony_tpu_torch.retry\n"
        "import tony_tpu_torch.checkpoint, tony_tpu_torch.parallel.grad_sync\n"
        "import tony_tpu_torch.conf.keys, tony_tpu_torch.constants\n"
        "import tony_tpu_torch.utils.durable\n"
        "import tony_tpu_torch.parallel.pipeline, tony_tpu_torch.pool\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _reference_module_strings(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for m in REFERENCE_MODULE.finditer(node.value):
                yield node.lineno, node.value[m.start():m.start() + 40]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_string_names_a_reference_module(path):
    """Every string that names a module names the port's: a leftover
    ``tony_tpu.`` in a spawn's argv would run the reference's coordinator
    or executor, and the job would still pass."""
    bad = list(_reference_module_strings(path))
    assert not bad, f"{os.path.relpath(path, REPO)}: {bad}"


def test_reference_module_scan_finds_a_spawn_argv():
    """The scan sees the strings a spawn would pass."""
    src = 'cmd = [python, "-m", "tony_tpu.executor"]\nx = "tony_tpu_torch.cli"\n'
    tree = ast.parse(src)
    found = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and REFERENCE_MODULE.search(n.value)]
    assert found == ["tony_tpu.executor"]


def test_control_plane_imports_without_torch():
    """The client, coordinator and executor processes start without torch
    (or jax, or the reference): their cold start must not pay for it."""
    code = (
        "import sys\n"
        "import tony_tpu_torch, tony_tpu_torch.cli.main\n"
        "import tony_tpu_torch.coordinator.__main__\n"
        "import tony_tpu_torch.executor.executor\n"
        "import tony_tpu_torch.client, tony_tpu_torch.cluster.local\n"
        "import tony_tpu_torch.pool, tony_tpu_torch.cluster\n"
        "import tony_tpu_torch.cluster.gpu, tony_tpu_torch.cluster.gcloud\n"
        "import tony_tpu_torch.fleet.daemon, tony_tpu_torch.fleet.client\n"
        "import tony_tpu_torch.fleet.__main__, tony_tpu_torch.fleet.simulator\n"
        "import tony_tpu_torch.fleet.diagnose, tony_tpu_torch.fleet.health\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN + ("torch",),))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["parallel/pipeline.py", "pool.py",
                                    "cli/main.py", "fleet/daemon.py",
                                    "cluster/gpu.py", "cluster/gcloud.py"])
def test_spawn_argvs_name_the_port(module):
    """The scans above cover the pipeline, the pool, the fleet and the
    GPU host backend, and every ``-m`` module the pool (its workers), the
    CLI (the pool and fleet daemons), the fleet daemon (its jobs'
    ``cli submit`` clients) and the pipeline spawn is the port's."""
    path = os.path.join(REPO, "tony_tpu_torch", module)
    assert path in _port_files()
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.List):
            items = [e.value for e in node.elts
                     if isinstance(e, ast.Constant)]
            for i, v in enumerate(items[:-1]):
                if v == "-m":
                    assert items[i + 1].startswith("tony_tpu_torch."), \
                        (module, items)


def test_gates_and_failure_verbs_import_nothing_of_the_reference(tmp_path):
    """``devtools/{invariants,protocol,tonylint}.py`` and the CLI's
    ``check``, ``lint``, ``resize`` and ``migrate``, run in a fresh
    process, load nothing of jax or the reference, and not torch either
    (they are control-plane tools)."""
    job = tmp_path / "job"
    job.mkdir()
    (job / "session.journal.jsonl").write_text(
        '{"t": "gen", "generation": 1}\n')
    code = (
        "import sys\n"
        "from tony_tpu_torch.cli.main import main\n"
        "import tony_tpu_torch.devtools.protocol\n"
        "assert main(['check', %r]) == 0\n"
        "assert main(['lint', '--rule', 'bare-except']) == 0\n"
        "assert main(['resize', 'app-x', '2', '--workdir', %r]) == 1\n"
        "assert main(['migrate', 'app-x', 'slice-1', '--workdir', %r]) == 1\n"
        "assert 'tony_tpu_torch.devtools.invariants' in sys.modules\n"
        "assert 'tony_tpu_torch.devtools.tonylint' in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
        % (str(job), str(tmp_path), str(tmp_path), FORBIDDEN + ("torch",)))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["devtools/invariants.py",
                                    "devtools/protocol.py",
                                    "devtools/tonylint.py"])
def test_gates_are_scanned(module):
    """The AST and string scans above cover the gates copied from the
    reference."""
    assert os.path.join(REPO, "tony_tpu_torch", module) in _port_files()


FLEET_AND_HOST_MODULES = sorted(
    ["cluster/gpu.py", "cluster/gcloud.py", "cluster/__init__.py"]
    + [f"fleet/{f}" for f in os.listdir(os.path.join(REPO, "tony_tpu_torch",
                                                     "fleet"))
       if f.endswith(".py")])


def test_fleet_and_host_backend_are_all_there():
    """Every module of the reference's fleet/ has its counterpart."""
    ref = sorted(f for f in os.listdir(os.path.join(REPO, "tony_tpu",
                                                    "fleet"))
                 if f.endswith(".py"))
    assert [m for m in FLEET_AND_HOST_MODULES if m.startswith("fleet/")] \
        == [f"fleet/{f}" for f in ref]


@pytest.mark.parametrize("module", FLEET_AND_HOST_MODULES)
def test_fleet_and_host_backend_are_scanned(module):
    """The AST and string scans above cover the GPU host backend and the
    fleet."""
    assert os.path.join(REPO, "tony_tpu_torch", module) in _port_files()


def test_fleet_and_gcloud_verbs_import_nothing_of_the_reference(tmp_path):
    """``cli fleet`` (offline verbs), ``cli gcloud-gc`` and ``cli trace
    --fleet`` run in a fresh process without jax, torch or the
    reference."""
    golden = os.path.join(REPO, "tests", "fixtures", "golden_fleetdir")
    code = (
        "import sys\n"
        "from tony_tpu_torch.cli.main import main\n"
        "assert main(['fleet', 'diagnose', '--dir', %r]) == 0\n"
        "assert main(['fleet', 'whatif', '--dir', %r]) == 0\n"
        "assert main(['fleet', 'explain', 'fj-0001', '--dir', %r]) in (0, 1)\n"
        "assert main(['check', %r]) == 0\n"
        "assert main(['trace', '--fleet', %r]) == 1\n"
        "assert main(['gcloud-gc', '--help']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
        % (golden, golden, golden, golden, str(tmp_path),
           FORBIDDEN + ("torch",)))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


OBSERVER_MODULES = sorted(
    ["notebook.py", "proxy.py", "workflow.py"]
    + [f"{pkg}/{f}" for pkg in ("portal", "chaos")
       for f in os.listdir(os.path.join(REPO, "tony_tpu", pkg))
       if f.endswith(".py")])

#: Modules of the reference with no counterpart, each on purpose: JAX
#: version shims (PyTorch has nothing to shim), and the TPU slice backend,
#: whose counterpart is ``cluster/gpu.py``.
NO_COUNTERPART = {"compat.py", "cluster/tpu.py"}


def _modules(pkg):
    root = os.path.join(REPO, pkg)
    out = set()
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "_build", "csrc")]
        out |= {os.path.relpath(os.path.join(dirpath, f), root)
                for f in files if f.endswith(".py")}
    return out


def test_every_reference_module_has_its_counterpart():
    missing = _modules("tony_tpu") - _modules("tony_tpu_torch")
    assert missing == NO_COUNTERPART


@pytest.mark.parametrize("module", OBSERVER_MODULES)
def test_observer_modules_are_scanned(module):
    """The AST and string scans above cover the portal, the chaos engine,
    the notebook, the proxy and the workflow adapter."""
    assert len(OBSERVER_MODULES) == 12
    assert os.path.join(REPO, "tony_tpu_torch", module) in _port_files()


def _verbs(parser):
    """{verb: nested verbs} of an argparse parser, recursively."""
    import argparse

    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = _verbs(sub)
    return out


def test_cli_has_every_reference_verb():
    from tony_tpu.cli.main import build_parser as j_build_parser
    from tony_tpu_torch.cli.main import build_parser

    ours, ref = _verbs(build_parser()), _verbs(j_build_parser())
    assert ours == ref
    for verb in ("notebook", "top", "profile", "bench", "alerts",
                 "portal", "chaos"):
        assert verb in ours


def test_observer_verbs_import_nothing_of_the_reference(tmp_path):
    """The portal, the chaos engine, the notebook, proxy and workflow
    modules and the observer verbs (``top``, ``profile``, ``alerts``,
    ``bench diff``, ``chaos``), in a fresh process, load nothing of jax or
    the reference, and not torch either."""
    fixtures = os.path.join(REPO, "benchmarks", "fixtures")
    code = (
        "import sys\n"
        "from tony_tpu_torch.cli.main import main\n"
        "import tony_tpu_torch.portal.server, tony_tpu_torch.portal.__main__\n"
        "import tony_tpu_torch.chaos.runner, tony_tpu_torch.chaos.oracle\n"
        "import tony_tpu_torch.notebook, tony_tpu_torch.proxy\n"
        "import tony_tpu_torch.workflow\n"
        "w = %r\n"
        "assert main(['top', 'app-x', '--once', '--workdir', w]) == 1\n"
        "assert main(['profile', 'app-x', '--workdir', w]) == 1\n"
        "assert main(['alerts', 'app-x', '--workdir', w,\n"
        "             '--history-root', w]) == 1\n"
        "assert main(['bench', 'diff', %r, %r]) == 0\n"
        "from tony_tpu_torch.chaos import plan\n"
        "assert plan(17, 0, 'e2e').injections\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
        % (str(tmp_path), os.path.join(fixtures, "bench_base.json"),
           os.path.join(fixtures, "bench_ok.json"), FORBIDDEN + ("torch",)))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
