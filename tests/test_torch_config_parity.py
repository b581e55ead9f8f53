"""Port parity of the configurations: every ``@dataclass`` of the JAX
package has its counterpart in ``tony_tpu_torch`` (the same module path
and class name), with the reference's fields and their
defaults (JAX dtypes mapped to torch's by name). A field the reference has
and the port lacks fails here, as ``TransformerConfig.remat_policy`` did.

The port may add fields of its own. The reference's fields that have no
counterpart, each for a reason:

- ``ShardedBatchIterator.shardings``: JAX ``NamedSharding``s that place a
  batch on the mesh's devices; the port's iterator places a rank's rows on
  its own device (``device``), its rows from the ``mesh`` or ``rank`` /
  ``world``;
- ``TrainState.params``, ``tx``, ``opt_state``: optax's functional state;
  the port's state is the module (``model``) and its
  ``torch.optim.Optimizer``, which hold the same values in place.

Fields the reference requires and the port defaults, each for a reason:
``ShardedBatchIterator.mesh`` (None: a rank's rows from ``rank`` /
``world`` instead) and ``TrainState.step`` (0: a fresh state).
"""

import ast
import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_ONLY = {
    ("tony_tpu.data", "ShardedBatchIterator"): {"shardings"},
    ("tony_tpu.parallel.train", "TrainState"): {"params", "tx", "opt_state"},
}
PORT_DEFAULTS = {
    ("tony_tpu.data", "ShardedBatchIterator", "mesh"): None,
    ("tony_tpu.parallel.train", "TrainState", "step"): 0,
}


def _reference_dataclasses():
    """(module, class name) of every class the JAX package decorates with
    a dataclass decorator, found in its source."""
    found = []
    for root, _, files in os.walk(os.path.join(REPO, "tony_tpu")):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            module = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
            if module.endswith(".__init__"):
                module = module[:-len(".__init__")]
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ClassDef) and any(
                        "dataclass" in ast.unparse(d)
                        for d in node.decorator_list):
                    found.append((module, node.name))
    return sorted(found)


DATACLASSES = _reference_dataclasses()


def test_the_scan_finds_the_reference_dataclasses():
    assert len(DATACLASSES) == 52
    assert ("tony_tpu.models.transformer", "TransformerConfig") in DATACLASSES


def _same(want, got):
    """A reference default against the port's: JAX / numpy dtypes against
    torch dtypes by name, anything else by repr."""
    if isinstance(got, torch.dtype):
        return np.dtype(want).name == str(got).rsplit(".", 1)[-1]
    return repr(want) == repr(got)


def _default(field):
    if field.default is not dataclasses.MISSING:
        return field.default
    if field.default_factory is not dataclasses.MISSING:
        return field.default_factory()
    return dataclasses.MISSING


@pytest.mark.parametrize("module,name", DATACLASSES,
                         ids=[f"{m}.{n}" for m, n in DATACLASSES])
def test_port_has_the_reference_fields_and_defaults(module, name):
    ref = getattr(importlib.import_module(module), name)
    port_module = "tony_tpu_torch" + module[len("tony_tpu"):]
    port = getattr(importlib.import_module(port_module), name)
    assert dataclasses.is_dataclass(port), f"{port_module}.{name}"
    jax_only = JAX_ONLY.get((module, name), set())
    want = [f for f in dataclasses.fields(ref) if f.name not in jax_only]
    have = {f.name: f for f in dataclasses.fields(port)}
    missing = [f.name for f in want if f.name not in have]
    assert not missing, f"{port_module}.{name} lacks {missing}"
    for f in want:
        ref_default, port_default = _default(f), _default(have[f.name])
        if ref_default is dataclasses.MISSING:
            key = (module, name, f.name)
            expect = PORT_DEFAULTS.get(key, dataclasses.MISSING)
            assert port_default is dataclasses.MISSING \
                if expect is dataclasses.MISSING else port_default == expect, \
                (key, port_default)
            continue
        assert _same(ref_default, port_default), \
            (f"{name}.{f.name}", ref_default, port_default)
