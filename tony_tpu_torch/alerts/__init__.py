"""Watchtower: the live SLO/alerting engine (ISSUE 19).

Everything observability built so far is post-mortem or operator-pulled;
this package watches the metric families continuously and says "this is
breaching NOW". Stdlib only — the rule engine, the pending→firing→
resolved state machine and the burn-rate error-budget accounting all
live in :mod:`tony_tpu_torch.alerts.rules`; the coordinator monitor tick and
the fleet daemon tick evaluate their packs behind the never-blocks-the-
tick degrade contract and journal every transition write-ahead
(``REC_ALERT`` / ``REC_FLEET_ALERT``), so a firing alert survives a
SIGKILL + ``--recover``.
"""

from tony_tpu_torch.alerts.rules import (  # noqa: F401
    AlertEngine,
    PromSource,
    RegistrySource,
    Rule,
    Slo,
    Transition,
    default_fleet_pack,
    default_job_pack,
    pack_series,
)
