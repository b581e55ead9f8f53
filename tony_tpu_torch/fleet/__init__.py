"""Fleet: a persistent multi-job gang scheduler over a shared slice pool.

TonY delegated everything above one job — queueing, quotas, priorities,
preemption — to YARN's ResourceManager (SURVEY §1 L4/L3); this package is
that layer rebuilt for accelerator slices. A persistent daemon (``cli fleet
start`` / ``python -m tony_tpu_torch.fleet serve``) owns a pool of slices
and gang-schedules many jobs against it:

- **policy engine** (``policy.py``, stdlib-only): priority queues with
  FIFO tiebreak, per-tenant host quotas that queue rather than starve
  other tenants, bin-packing of sub-slice jobs onto shared slices, and
  preempt-to-reclaim victim selection that shrinks elastic jobs toward
  their floor instead of killing them.
- **write-ahead journal** (``journal.py``): every submission, grant,
  preemption and state transition fsync'd before it is acted on — the
  same ``REC_*``/replay/torn-tail discipline as ``coordinator/
  journal.py`` — so ``fleet start --recover`` resumes the same queue
  state with zero duplicated or lost grants.
- **daemon** (``daemon.py``): the RPC plane (``fleet.submit`` /
  ``fleet.status`` / ``fleet.cancel`` / ``fleet.stop`` over rpc/wire.py,
  token-authed, generation-fenced), per-job coordinator launches against
  leased hosts (the ordinary ``tony-tpu submit`` stack, one client
  subprocess per grant), elastic-shrink preemption driving
  ``coordinator/elastic.py``'s absorb path, warm-pool injection into
  every grant, and the ``tony_fleet_*``
  metric families + fleet event stream.

Maple (PAPERS.md) is the template for portable multi-cluster scheduling,
Arax for decoupling jobs from the accelerators they land on; the warm
executor pool (``tony_tpu_torch/pool.py``) is the executor substrate and
LocalSim + virtual executors the drill substrate at width.

Deliberately no re-exports: ``python -m tony_tpu_torch.fleet.policy`` is the
no-deps CI smoke, and an ``__init__`` that pre-imports the module would
shadow the runpy execution (and drag the policy import into every
``tony_tpu_torch.fleet`` consumer that only wants the client).
"""
