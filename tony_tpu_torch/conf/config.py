"""Layered configuration with a frozen "final config" artifact.

Reference model (``TonyClient.initTonyConf`` :483-517 and
``processFinalTonyConf`` :189-228): defaults ← job config file ← explicit
``-conf k=v`` overrides ← site file, frozen into a single ``tony-final.xml``
that is localized to the AM and every container, so every process reads one
source of truth (``ApplicationMaster.java:216``, ``TaskExecutor.java:269``).

This build keeps the exact layering but uses JSON/YAML instead of Hadoop XML,
and the frozen artifact is ``tony-final.json`` (constants.FINAL_CONFIG_FILE).
Multi-value keys append across layers (reference ``TonyClient.java:498-510``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from tony_tpu_torch import constants
from tony_tpu_torch.conf import keys as K


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class JobType:
    """A gang of identical tasks (reference per-jobtype dynamic keys,
    ``TonyConfigurationKeys.java:171-239``)."""

    name: str
    instances: int = 0
    command: str = ""
    chips: int = 0
    vcores: int = 1
    memory: str = "2g"
    depends_on: Tuple[str, ...] = ()
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    node_pool: str = ""
    docker_image: str = ""

    @property
    def is_chief_type(self) -> bool:
        return self.name == constants.CHIEF_JOB_NAME


def _load_file(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml  # baked in

        data = yaml.safe_load(text) or {}
    else:
        data = json.loads(text or "{}")
    if not isinstance(data, dict):
        raise ConfigError(f"config file {path} must contain a mapping")
    return _flatten(data)


def _flatten(data: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Allow nested mappings in config files: {"tony": {"worker": {"instances": 2}}}
    flattens to dotted keys."""
    out: Dict[str, Any] = {}
    for k, v in data.items():
        name = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = v
    return out


class TonyTpuConfig:
    """Dict-backed layered configuration."""

    def __init__(self, initial: Optional[Mapping[str, Any]] = None):
        self._conf: Dict[str, Any] = {}
        for key in K.registry().values():
            self._conf[key.name] = key.default
        if initial:
            for k, v in initial.items():
                self.set(k, v)

    # -- layering ---------------------------------------------------------
    @classmethod
    def from_layers(
        cls,
        config_file: Optional[str] = None,
        overrides: Iterable[str] = (),
        site_dir: Optional[str] = None,
    ) -> "TonyTpuConfig":
        """defaults ← config_file ← overrides(k=v) ← site file.

        Mirrors ``TonyClient.initTonyConf`` :483-517 (the site file is the
        last layer there too: ``$TONY_CONF_DIR/tony-site.xml``).
        """
        conf = cls()
        if config_file:
            conf.merge(_load_file(config_file))
            conf._resolve_file_relative_paths(os.path.dirname(
                os.path.abspath(config_file)))
        for kv in overrides:
            if "=" not in kv:
                raise ConfigError(f"override must be key=value, got {kv!r}")
            k, v = kv.split("=", 1)
            conf.set(k.strip(), v)
        site_dir = site_dir or os.environ.get("TONY_TPU_CONF_DIR", "")
        if site_dir:
            for fname in ("tony-site.json", "tony-site.yaml"):
                p = os.path.join(site_dir, fname)
                if os.path.exists(p):
                    conf.merge(_load_file(p))
                    break
        return conf

    def merge(self, other: Mapping[str, Any]) -> None:
        for k, v in other.items():
            self.set(k, v)

    def _resolve_file_relative_paths(self, base_dir: str) -> None:
        """Relative paths in a job config resolve against the config
        file's directory, not the caller's CWD — so
        ``submit --conf-file examples/mnist-jax/mnist.json`` works from
        anywhere (the examples all say ``src-dir: "."``). Only applied to
        values that exist under the file's dir with the right kind
        (src-dir: directory, venv: file); anything else is left for CWD
        resolution (the CLI-flag behavior)."""
        def resolve(v: str, want) -> str:
            if not v or os.path.isabs(v):
                return v
            cand = os.path.normpath(os.path.join(base_dir, v))
            return cand if want(cand) else v

        for key, want in ((K.SRC_DIR, os.path.isdir),
                          (K.PYTHON_VENV, os.path.isfile)):
            v = str(self.get(key, "") or "")
            resolved = resolve(v, want)
            if resolved != v:
                self.set(key, resolved)
        # Container resources share the same file-relative intent; their
        # SRC[::NAME][#archive] annotations must survive the rewrite.
        specs = self.get_list(K.CONTAINER_RESOURCES)
        if specs:
            from tony_tpu_torch.utils.localize import LocalizableResource

            import dataclasses as _dc

            out = []
            for spec in specs:
                try:
                    r = LocalizableResource.parse(spec)
                except ValueError:
                    out.append(spec)     # staging reports the bad spec
                    continue
                r = _dc.replace(r, source=resolve(r.source, os.path.exists))
                out.append(r.unparse())
            if out != specs:
                self.unset(K.CONTAINER_RESOURCES)
                for spec in out:
                    self.set(K.CONTAINER_RESOURCES, spec)

    # -- access -----------------------------------------------------------
    def set(self, name: str, value: Any) -> None:
        if (name.startswith("tony.") and name not in K.registry()
                and K.parse_job_key(name) is None):
            # Arbitrary keys pass through (reference Hadoop Configuration
            # semantics), but a tony.* key that matches nothing is almost
            # always a typo — say so instead of silently ignoring it.
            import logging
            logging.getLogger(__name__).warning(
                "config key %r matches no registered key or jobtype "
                "pattern — possible typo (value kept as passthrough)", name)
        value = K.coerce(name, value)
        if K.is_multi_value(name) and self._conf.get(name):
            existing = str(self._conf[name])
            incoming = str(value)
            if existing and incoming and incoming not in existing.split(","):
                value = f"{existing},{incoming}"
        self._conf[name] = value

    def unset(self, name: str) -> None:
        """Remove a key entirely (e.g. scrubbing credentials before the
        config is frozen into a world-readable artifact)."""
        self._conf.pop(name, None)

    def get(self, name: str, default: Any = None) -> Any:
        if name in self._conf:
            return self._conf[name]
        key = K.registry().get(name)
        if key is not None:
            return key.default
        return default

    def get_int(self, name: str, default: int = 0) -> int:
        v = self.get(name, default)
        return int(v) if v is not None and v != "" else default

    def get_bool(self, name: str, default: bool = False) -> bool:
        v = self.get(name, default)
        if isinstance(v, str):
            return v.strip().lower() in ("true", "1", "yes", "on")
        return bool(v)

    def get_list(self, name: str) -> List[str]:
        v = self.get(name, "")
        if not v:
            return []
        return [s.strip() for s in str(v).split(",") if s.strip()]

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._conf)

    # -- jobtypes ---------------------------------------------------------
    def job_types(self) -> Dict[str, JobType]:
        """Discover jobtypes from dynamic keys (reference
        ``TonyConfigurationKeys.getJobTypes`` + ``Utils.parseContainerRequests``
        :366-408)."""
        names = set()
        for name in self._conf:
            jk = K.parse_job_key(name)
            if jk:
                names.add(jk[0])
        jobs: Dict[str, JobType] = {}
        for job in sorted(names):
            instances = self.get_int(K.INSTANCES_FORMAT.format(job=job), 0)
            if instances <= 0:
                continue
            env_pairs = {}
            for kv in self.get_list(K.ENV_FORMAT.format(job=job)):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    env_pairs[k] = v
            jobs[job] = JobType(
                name=job,
                instances=instances,
                command=str(self.get(K.COMMAND_FORMAT.format(job=job), "") or ""),
                chips=self.get_int(K.CHIPS_FORMAT.format(job=job), 0),
                vcores=self.get_int(K.VCORES_FORMAT.format(job=job), 1),
                memory=str(self.get(K.MEMORY_FORMAT.format(job=job), "2g")),
                depends_on=tuple(self.get_list(K.DEPENDS_ON_FORMAT.format(job=job))),
                env=env_pairs,
                node_pool=str(self.get(K.NODE_POOL_FORMAT.format(job=job), "") or ""),
                docker_image=str(self.get(
                    K.DOCKER_IMAGE_FORMAT.format(job=job), "") or ""),
            )
        return jobs

    def untracked_jobtypes(self) -> Tuple[str, ...]:
        return tuple(self.get_list(K.APPLICATION_UNTRACKED_JOBTYPES))

    # -- validation -------------------------------------------------------
    def validate(self) -> None:
        """Quota + sanity checks (reference ``TonyClient.validateTonyConf``
        :598-667: instance and resource quota enforcement at submit time)."""
        jobs = self.job_types()
        if not jobs and not str(self.get(K.COORDINATOR_COMMAND, "") or "") \
                and not str(self.get(K.APPLICATION_EXECUTABLE, "") or ""):
            # Zero jobtypes is legal only for single-node mode, where the
            # coordinator itself runs the command (reference
            # ApplicationMaster.java:714 single-node path).
            raise ConfigError(
                "no jobtypes configured: set tony.<job>.instances >= 1 "
                "(or a coordinator-local command for single-node mode)")
        total_instances = sum(j.instances for j in jobs.values())
        max_total = self.get_int(K.MAX_TOTAL_INSTANCES, -1)
        if max_total >= 0 and total_instances > max_total:
            raise ConfigError(
                f"requested {total_instances} instances exceeds quota "
                f"{max_total} ({K.MAX_TOTAL_INSTANCES})")
        total_chips = sum(j.instances * j.chips for j in jobs.values())
        max_chips = self.get_int(K.MAX_TOTAL_CHIPS, -1)
        if max_chips >= 0 and total_chips > max_chips:
            raise ConfigError(
                f"requested {total_chips} chips exceeds quota {max_chips} "
                f"({K.MAX_TOTAL_CHIPS})")
        for j in jobs.values():
            cap = self.get_int(K.MAX_INSTANCES_FORMAT.format(job=j.name), -1)
            if cap >= 0 and j.instances > cap:
                raise ConfigError(
                    f"jobtype {j.name}: {j.instances} instances exceeds "
                    f"max-instances {cap}")
            for dep in j.depends_on:
                if dep not in jobs:
                    raise ConfigError(
                        f"jobtype {j.name} depends on unknown jobtype {dep}")
        # TLS wants the pair: a cert without its key would crash the
        # SPAWNED coordinator before it writes its address file, and the
        # submitter would see only "coordinator address never appeared".
        tls_cert = str(self.get(K.SECURITY_TLS_CERT, "") or "")
        tls_key = str(self.get(K.SECURITY_TLS_KEY, "") or "")
        if bool(tls_cert) != bool(tls_key):
            raise ConfigError(
                f"{K.SECURITY_TLS_CERT} and {K.SECURITY_TLS_KEY} must be "
                f"set together (got cert={tls_cert!r}, key={tls_key!r})")

    # -- freeze / thaw ----------------------------------------------------
    def freeze(self, path: str) -> str:
        """Write the frozen final config artifact (``tony-final.json``),
        the single source of truth shipped to coordinator and executors
        (reference ``tony-final.xml``, Constants.java:139). Atomic +
        fsync'd (utils/durable.py): executors fetch this file while the
        coordinator may crash and be recovered at any moment — a torn
        config is a gang-wide poison pill."""
        from tony_tpu_torch.utils.durable import atomic_write

        atomic_write(path, json.dumps(self._conf, indent=2,
                                      sort_keys=True).encode("utf-8"))
        return path

    @classmethod
    def load_final(cls, path: str) -> "TonyTpuConfig":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        conf = cls()
        conf._conf.update(data)  # already-coerced values; bypass multi-value append
        return conf
