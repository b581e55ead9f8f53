"""Developer tooling: machine-checkable invariants for the orchestrator.

Four layers, one discipline (docs/development.md):

- ``tonylint`` — an AST-based static pass over the ``tony_tpu_torch`` package
  that enforces the project's implicit registries (conf keys, fault
  sites, event types, RPC surface) and coding disciplines (durable
  writes, monotonic clocks, span/thread hygiene, no blocking under
  coordinator locks). Run it with ``tony-tpu lint``; it also runs inside
  tier-1 (``tests/test_lint.py``) and as its own CI job.
- ``protocol`` — tonylint's v2 rule module: six flow-aware rules that
  extract BOTH halves of the coordinator↔executor protocol (heartbeat
  directives, journal record types, gen/mgen fences, beacon fields,
  terminal-state discipline, the metrics-series registry) and check
  them against each other.
- ``invariants`` — the runtime counterpart: ``tony-tpu check`` verifies
  a finished job dir's artifacts (journal, span log, perf, metrics)
  against the same protocol; auto-armed over every e2e/virtual-gang
  drill by ``tests/conftest.py``.
- ``sanitizer`` — a runtime lock sanitizer (env flag
  ``TONY_LOCK_SANITIZER=1``) that records the lock-order graph and
  hold-while-blocking hazards across the whole tier-1 suite.

The strict-core typecheck gate (``mypy --strict`` over
``pyproject.toml [tool.mypy]``) covers this package end to end.
"""
