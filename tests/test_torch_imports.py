"""The port stands alone: no file of tony_tpu_torch/ and not chip_smoke.py
imports jax, flax, optax or tony_tpu, and importing the package leaves jax
out of sys.modules."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tony_tpu")


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
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
