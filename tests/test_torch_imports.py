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
        "import tony_tpu_torch.pool\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN + ("torch",),))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("module", ["parallel/pipeline.py", "pool.py",
                                    "cli/main.py"])
def test_spawn_argvs_name_the_port(module):
    """The scans above cover the pipeline and the pool, and every ``-m``
    module the pool (its workers), the CLI (the pool daemon) and the
    pipeline spawn is the port's."""
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
