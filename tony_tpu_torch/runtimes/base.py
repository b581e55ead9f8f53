"""Framework runtimes: translate the cluster spec into each ML framework's
rendezvous environment.

Reference model: the framework switch in ``TaskExecutor.java:161-207`` —
TENSORFLOW exports TF_CONFIG/CLUSTER_SPEC, PYTORCH exports
INIT_METHOD/RANK/WORLD, MXNET exports DMLC_*, HOROVOD exports nothing —
with the spec-formatting logic in ``util/Utils.java`` (``constructTFConfig``
:491, ``parseClusterSpecForPytorch`` :575, MXNet :587-609).

New here: **JAXRuntime**, the TPU-native first-class citizen. It replaces all
the dialects with ``jax.distributed.initialize`` bootstrap variables computed
from the same cluster spec, so one rendezvous mechanism serves every JAX job
(SURVEY.md §2.4). GENERIC serves arbitrary gang topologies (the Ray pattern,
``tony-examples/ray-on-tony``) by exporting only CLUSTER_SPEC.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Type

from tony_tpu_torch import constants
from tony_tpu_torch.conf.config import TonyTpuConfig


@dataclasses.dataclass
class TaskIdentity:
    job_name: str
    index: int
    task_num: int
    is_chief: bool
    port: int  # reserved rendezvous port of THIS task


def flatten_spec(cluster_spec: Dict[str, List[str]]) -> List[str]:
    """Deterministic global ordering of tasks: chief first, then worker, then
    remaining jobtypes alphabetically; within a jobtype by index. Defines the
    global-rank contract shared by JAX/PyTorch runtimes."""
    order = []
    names = sorted(cluster_spec)
    for special in (constants.CHIEF_JOB_NAME, constants.WORKER_JOB_NAME):
        if special in cluster_spec:
            order.append(special)
    order.extend(n for n in names if n not in order)
    flat: List[str] = []
    for name in order:
        flat.extend(f"{name}:{i}" for i in range(len(cluster_spec[name])))
    return flat


def task_addr(cluster_spec: Dict[str, List[str]], task_id: str) -> str:
    job, _, idx = task_id.partition(":")
    return cluster_spec[job][int(idx)]


class Runtime:
    name = "generic"

    def build_env(self, cluster_spec: Dict[str, List[str]],
                  me: TaskIdentity, conf: TonyTpuConfig) -> Dict[str, str]:
        """Environment exported to the user process. Every runtime also gets
        CLUSTER_SPEC + the tony-tpu global-rank contract."""
        flat = flatten_spec(cluster_spec)
        my_id = f"{me.job_name}:{me.index}"
        env = {
            constants.CLUSTER_SPEC: json.dumps(cluster_spec, sort_keys=True),
            constants.GLOBAL_RANK: str(flat.index(my_id)),
            constants.GLOBAL_WORLD: str(len(flat)),
            constants.TASK_PORT: str(me.port),
        }
        env.update(self.framework_env(cluster_spec, me, conf))
        return env

    def framework_env(self, cluster_spec: Dict[str, List[str]],
                      me: TaskIdentity, conf: TonyTpuConfig) -> Dict[str, str]:
        return {}


_REGISTRY: Dict[str, Type[Runtime]] = {}


def register(cls: Type[Runtime]) -> Type[Runtime]:
    _REGISTRY[cls.name] = cls
    return cls


def get_runtime(name: str) -> Runtime:
    """Look up a runtime by ``tony.application.framework`` value (reference
    ``MLFramework`` enum, ``TonyConfigurationKeys.java:12-17``)."""
    # Import side-effect registration.
    from tony_tpu_torch.runtimes import frameworks  # noqa: F401

    cls = _REGISTRY.get(name.lower())
    if cls is None:
        raise ValueError(
            f"unknown framework {name!r}; known: {sorted(_REGISTRY)}")
    return cls()


register(Runtime)
