"""Host health: failure attribution, quarantine, probation, probes.

The reference delegated node health entirely to YARN (the NodeManager
health check + node blacklist); this module is that last substrate
layer for the fleet. Without it a flaky host is re-granted to the next
job forever and every retry can land straight back on the machine that
just killed the task.

Model:

- Hosts are the fleet pool's ``slices x hosts_per_slice`` slots, named
  ``s<slice>h<index>`` (synthetic, stable identity — the policy engine
  accounts counts, this book accounts WHICH hosts those counts are).
- Every attributed failure (TASK_FINISHED with an infra failure domain,
  heartbeat expiry, host.loss absorb, straggler/hang kill — USER_ERROR
  never counts: a user bug says nothing about the machine) adds to a
  per-host score that DECAYS with a half-life, so one bad afternoon
  does not brand a host forever but a recurring fault accumulates.
- The score drives a state machine::

      healthy -> suspect -> quarantined -> probation -> healthy
                                 ^                |
                                 +--- (failure) --+  cooldown doubles

  Quarantined/probation hosts are CORDONED: the placement filter takes
  them out of the free pool, so no grant, retry or warm-pool lease can
  land on them. Quarantine expires into probation after a cooldown;
  probation re-admits the host only via a low-priority CANARY grant —
  a clean canary run restores the host, a failed one re-quarantines it
  with a doubled cooldown (exponential backoff on repeat offenders).
- Correlated detection: N suspect-or-worse hosts on ONE slice inside a
  window is a sick slice, not N sick hosts — the whole slice cordons
  and the daemon triggers evacuation migration off it.
- Every transition is journaled write-ahead as a ``REC_FLEET_HEALTH``
  record (fleet/journal.py) carrying its own evidence, so ``fleet
  start --recover`` resumes the identical cordon set and ``tony-tpu
  check`` can audit that no quarantine lacks attributed failures.

Pure and clock-injected (callers pass monotonic ``now``) so the state
machine unit-tests exhaustively without sleeping.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
from typing import Any, Dict, List, Optional, Tuple

from tony_tpu_torch import faults

log = logging.getLogger(__name__)

#: host health states (the REC_FLEET_HEALTH "state" field)
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"
#: states whose hosts are cordoned out of the placement pool
CORDONED_STATES = (QUARANTINED, PROBATION)

#: score added per attributed failure, by evidence kind. PREEMPTION is
#: the substrate reclaiming capacity — barely the host's fault, but a
#: host that keeps landing preemptions is worth suspicion; USER_ERROR
#: is never attributed (enforced by the callers, asserted here).
KIND_WEIGHTS: Dict[str, float] = {
    "INFRA_TRANSIENT": 1.0,
    "PREEMPTION": 0.25,
    "hang": 1.0,             # TASK_HUNG: wedged user process on this host
    "straggler": 0.5,        # TASK_STRAGGLER: persistent slow outlier
    "probe": 0.0,            # probe failures cordon directly, not by score
    "manual": 0.0,
}


def host_name(slice_index: int, host_index: int) -> str:
    """The synthetic stable host id for a pool slot."""
    return f"s{int(slice_index)}h{int(host_index)}"


def slice_of(host: str) -> int:
    """Slice index encoded in a host id (-1 for a malformed id)."""
    if not host.startswith("s") or "h" not in host:
        return -1
    try:
        return int(host[1:host.index("h")])
    except ValueError:
        return -1


@dataclasses.dataclass
class HealthConfig:
    """The tony.health.* conf family, resolved once at daemon start."""

    enabled: bool = True
    half_life_s: float = 300.0        # score half-life
    suspect_threshold: float = 1.0    # score >= this -> suspect
    quarantine_threshold: float = 3.0  # score >= this -> quarantined
    quarantine_s: float = 120.0       # initial quarantine cooldown
    probation_priority: int = 0       # canary grants: priority <= this
    blast_n: int = 2                  # suspects on one slice -> sick slice
    blast_window_s: float = 120.0     # ...inside this window
    evidence_cap: int = 16            # evidence entries kept per host


@dataclasses.dataclass
class HostHealth:
    """One host's ledger entry."""

    host: str
    slice_index: int
    state: str = HEALTHY
    score: float = 0.0
    manual: bool = False              # operator cordon (never auto-expires)
    updated_mono: float = 0.0         # decay anchor
    cordoned_mono: float = 0.0        # when the quarantine began
    cooldown_s: float = 0.0           # current quarantine cooldown (backoff)
    evidence: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @property
    def cordoned(self) -> bool:
        return self.state in CORDONED_STATES


class HostBook:
    """Per-host identity + health over the fleet pool, kept in lockstep
    with the policy engine's :class:`SlicePool` counts: for every slice
    ``len(free_hosts(i)) == pool free`` and ``len(cordoned on i) ==
    pool cordoned``. The daemon owns the lock; this book is plain
    state."""

    def __init__(self, slices: int, hosts_per_slice: int,
                 config: Optional[HealthConfig] = None) -> None:
        self.slices = int(slices)
        self.hosts_per_slice = int(hosts_per_slice)
        self.config = config or HealthConfig()
        self.hosts: Dict[str, HostHealth] = {}
        self._free: List[List[str]] = []
        for i in range(self.slices):
            ids = [host_name(i, j) for j in range(self.hosts_per_slice)]
            self._free.append(list(ids))
            for h in ids:
                self.hosts[h] = HostHealth(host=h, slice_index=i)
        #: job -> assigned host ids (insertion order = task index order)
        self.assigned: Dict[str, List[str]] = {}
        #: slices already declared sick (one evacuation per episode)
        self._sick_slices: set = set()

    # -- queries ---------------------------------------------------------
    def free_hosts(self, slice_index: int) -> List[str]:
        return list(self._free[slice_index])

    def cordoned_hosts(self) -> List[HostHealth]:
        return sorted((h for h in self.hosts.values() if h.cordoned),
                      key=lambda h: h.host)

    def cordoned_names(self) -> List[str]:
        return [h.host for h in self.cordoned_hosts()]

    @property
    def sick_slices(self) -> List[int]:
        """Slices currently in a declared sick episode."""
        return sorted(self._sick_slices)

    def host_of_task(self, job_id: str, task_index: int) -> str:
        """Which host a job's task index runs on (tasks round-robin over
        the assigned hosts in order)."""
        hosts = self.assigned.get(job_id) or []
        if not hosts:
            return ""
        return hosts[int(task_index) % len(hosts)]

    def snapshot(self, now: float) -> List[Dict[str, Any]]:
        """Status rows for `fleet health` / the portal, worst first."""
        rank = {QUARANTINED: 0, PROBATION: 1, SUSPECT: 2, HEALTHY: 3}
        rows = []
        for h in sorted(self.hosts.values(),
                        key=lambda h: (rank.get(h.state, 9), h.host)):
            self._decay(h, now)
            rows.append({
                "host": h.host, "slice": h.slice_index, "state": h.state,
                "score": round(h.score, 3), "manual": h.manual,
                "cooldown_s": round(h.cooldown_s, 1),
                "failures": len(h.evidence),
                "evidence": list(h.evidence[-4:]),
            })
        return rows

    # -- scoring + the state machine -------------------------------------
    def _decay(self, h: HostHealth, now: float) -> None:
        if h.updated_mono and now > h.updated_mono and h.score > 0:
            h.score *= 0.5 ** ((now - h.updated_mono)
                               / max(1e-6, self.config.half_life_s))
        h.updated_mono = now

    def record_failure(self, host: str, kind: str, job_id: str,
                       now: float, ts_ms: int = 0) -> List[Dict[str, Any]]:
        """One attributed failure landed on ``host``. Returns the
        journal-ready transition records it caused (possibly none —
        scores accumulate silently below the thresholds). Callers must
        never attribute USER_ERROR."""
        assert kind != "USER_ERROR", "user errors are never attributed"
        h = self.hosts.get(host)
        if h is None:
            return []
        self._decay(h, now)
        h.score += KIND_WEIGHTS.get(kind, 1.0)
        h.evidence.append({"ts": int(ts_ms), "kind": kind, "job": job_id})
        del h.evidence[:-self.config.evidence_cap]
        out: List[Dict[str, Any]] = []
        if h.state == PROBATION:
            # A probationer that fails again goes straight back behind
            # the fence, and waits twice as long for its next chance.
            out.append(self._quarantine(
                h, now, reason=f"probation failure ({kind} in {job_id})",
                backoff=True))
        elif h.state in (HEALTHY, SUSPECT) \
                and h.score >= self.config.quarantine_threshold:
            out.append(self._quarantine(
                h, now,
                reason=f"score {h.score:.2f} >= quarantine threshold "
                       f"{self.config.quarantine_threshold:g}"))
        elif h.state == HEALTHY \
                and h.score >= self.config.suspect_threshold:
            h.state = SUSPECT
            out.append(self._record(
                h, reason=f"score {h.score:.2f} >= suspect threshold "
                          f"{self.config.suspect_threshold:g}"))
        return out

    def _quarantine(self, h: HostHealth, now: float, reason: str,
                    manual: bool = False,
                    backoff: bool = False) -> Dict[str, Any]:
        h.state = QUARANTINED
        h.manual = manual
        h.cordoned_mono = now
        if backoff and h.cooldown_s > 0:
            h.cooldown_s *= 2
        elif h.cooldown_s <= 0:
            h.cooldown_s = self.config.quarantine_s
        # A free host cordons immediately; an assigned one stays booked
        # until its job releases (the daemon sweeps it then). ``was_free``
        # on the record tells the daemon whether the pool's free count
        # must move to cordoned NOW (vs at job release).
        free = self._free[h.slice_index]
        was_free = h.host in free
        if was_free:
            free.remove(h.host)
        rec = self._record(h, reason=reason)
        rec["was_free"] = was_free
        return rec

    def cordon(self, host: str, reason: str, now: float,
               manual: bool = False, kind: str = "manual",
               ts_ms: int = 0) -> Optional[Dict[str, Any]]:
        """Force-quarantine (operator cordon, probe failure, sick
        slice). Returns the transition record, or None for an unknown
        host. ``was_free`` on the record tells the caller whether the
        pool's free count must drop NOW (vs at job release). The cause
        lands in the evidence trail too (kind "manual"/"probe"/...) so
        every quarantine record is self-evidencing — the
        health-quarantine-evidence check audits exactly that."""
        h = self.hosts.get(host)
        if h is None:
            return None
        self._decay(h, now)
        h.evidence.append({"ts": int(ts_ms), "kind": kind, "job": ""})
        del h.evidence[:-self.config.evidence_cap]
        return self._quarantine(h, now, reason=reason, manual=manual)

    def uncordon(self, host: str, now: float,
                 reason: str = "operator uncordon") -> Optional[Dict[str, Any]]:
        """Restore a cordoned host to service (operator verb, or a
        clean canary). Returns the transition record (with
        ``was_free`` False — the host re-enters the free pool only if
        it is not currently assigned), or None when the host is
        unknown or not cordoned."""
        h = self.hosts.get(host)
        if h is None or not h.cordoned:
            return None
        h.state = HEALTHY
        h.score = 0.0
        h.manual = False
        h.cooldown_s = 0.0
        h.updated_mono = now
        assigned = any(h.host in hs for hs in self.assigned.values())
        if not assigned and h.host not in self._free[h.slice_index]:
            self._free[h.slice_index].append(h.host)
            self._free[h.slice_index].sort()
        rec = self._record(h, reason=reason)
        rec["was_free"] = False
        rec["now_free"] = not assigned
        return rec

    def tick(self, now: float) -> Tuple[List[Dict[str, Any]], List[int]]:
        """Periodic pass: decay scores, expire suspects, roll
        quarantines into probation, and run correlated (sick-slice)
        detection. Returns (transition records, newly sick slices)."""
        out: List[Dict[str, Any]] = []
        for h in self.hosts.values():
            self._decay(h, now)
            if h.state == SUSPECT \
                    and h.score < self.config.suspect_threshold:
                h.state = HEALTHY
                out.append(self._record(
                    h, reason=f"score decayed to {h.score:.2f} < "
                              f"suspect threshold"))
            elif h.state == QUARANTINED and not h.manual \
                    and now - h.cordoned_mono >= h.cooldown_s:
                h.state = PROBATION
                out.append(self._record(
                    h, reason=f"quarantine cooldown "
                              f"({h.cooldown_s:.0f}s) expired — "
                              f"awaiting canary"))
        sick = self._detect_sick_slices(now)
        for i in sick:
            for h in self.hosts.values():
                if h.slice_index == i and h.state != QUARANTINED:
                    rec = self.cordon(
                        h.host, now=now, kind="slice",
                        reason=f"sick slice {i}: correlated failures "
                               f"across >= {self.config.blast_n} hosts")
                    if rec is not None:
                        out.append(rec)
        return out, sick

    def _detect_sick_slices(self, now: float) -> List[int]:
        window_ms = self.config.blast_window_s * 1000.0
        newest = 0
        for h in self.hosts.values():
            for ev in h.evidence:
                newest = max(newest, int(ev.get("ts", 0) or 0))
        sick: List[int] = []
        for i in range(self.slices):
            bad = 0
            for h in self.hosts.values():
                if h.slice_index != i or h.state == HEALTHY:
                    continue
                recent = any(newest - int(ev.get("ts", 0) or 0)
                             <= window_ms for ev in h.evidence)
                if recent or h.state == QUARANTINED:
                    bad += 1
            if bad >= self.config.blast_n and i not in self._sick_slices:
                self._sick_slices.add(i)
                sick.append(i)
            elif bad < self.config.blast_n:
                self._sick_slices.discard(i)
        return sick

    # -- assignment (lockstep with SlicePool allocate/release) -----------
    def assign(self, job_id: str, placement: Dict[int, int],
               priority: int,
               now: float) -> Tuple[List[str], List[Dict[str, Any]]]:
        """Pick concrete hosts for a grant placement. Low-priority
        grants (priority <= probation canary threshold) substitute at
        most ONE probation host per slice for a free one — the canary
        lease. Returns (assigned host ids, transition records for the
        canary re-admissions; each carries ``canary: True`` so the
        daemon can uncordon the pool slot)."""
        chosen: List[str] = []
        canaries: List[Dict[str, Any]] = []
        for i in sorted(placement):
            n = int(placement[i])
            free = self._free[i]
            take = sorted(free)[:n]
            if len(take) < n:
                raise ValueError(
                    f"slice {i}: placement wants {n} hosts but only "
                    f"{len(take)} identities are free (book out of "
                    f"sync with the pool)")
            if priority <= self.config.probation_priority:
                canary = next(
                    (h for h in self.cordoned_hosts()
                     if h.slice_index == i and h.state == PROBATION),
                    None)
                if canary is not None:
                    # swap: the canary takes a slot, one free host stays
                    take = take[:-1] + [canary.host]
                    rec = self._record(
                        canary,
                        reason=f"canary re-admission into {job_id!r} "
                               f"(priority {priority} <= "
                               f"{self.config.probation_priority})")
                    rec["canary"] = True
                    canaries.append(rec)
            for h in take:
                if h in free:
                    free.remove(h)
            chosen.extend(sorted(take))
        self.assigned[job_id] = chosen
        return chosen, canaries

    def unassign(self, job_id: str) -> None:
        """Back out an assignment that never became a grant (the probe
        self-repair loop): healthy hosts re-enter the free pool;
        cordoned picks (the canary, probe-cordoned hosts) stay out and
        keep their state."""
        for name in self.assigned.pop(job_id, []):
            h = self.hosts.get(name)
            if h is None or h.cordoned:
                continue
            if name not in self._free[h.slice_index]:
                self._free[h.slice_index].append(name)
                self._free[h.slice_index].sort()

    def adopt(self, job_id: str, placement: Dict[int, int],
              host_ids: Optional[List[str]] = None) -> List[str]:
        """Recovery path: re-book a running job's hosts (journaled ids
        when the grant record carried them, else lowest-free)."""
        chosen: List[str] = []
        for i in sorted(placement):
            need = int(placement[i])
            journaled = [h for h in (host_ids or [])
                         if slice_of(h) == i and h in self._free[i]]
            take = journaled[:need]
            for h in sorted(self._free[i]):
                if len(take) >= need:
                    break
                if h not in take:
                    take.append(h)
            for h in take:
                self._free[i].remove(h)
            chosen.extend(sorted(take))
        self.assigned[job_id] = chosen
        return chosen

    def release(self, job_id: str, now: float,
                failed: bool = False) -> Tuple[Dict[int, int],
                                               List[Dict[str, Any]]]:
        """A job released its hosts. Cordon-pending hosts (quarantined
        while assigned) stay out of the free pool — the returned
        ``{slice: count}`` of newly cordoned slots tells the daemon to
        move the pool's accounting from free to cordoned. Probation
        canaries resolve here: a clean run restores the host, a failed
        one re-quarantines with doubled cooldown."""
        hosts = self.assigned.pop(job_id, [])
        newly_cordoned: Dict[int, int] = {}
        out: List[Dict[str, Any]] = []
        for name in hosts:
            h = self.hosts.get(name)
            if h is None:
                continue
            if h.state == PROBATION:
                if failed:
                    rec = self._quarantine(
                        h, now, reason=f"canary job {job_id!r} failed",
                        backoff=True)
                    out.append(rec)
                    newly_cordoned[h.slice_index] = \
                        newly_cordoned.get(h.slice_index, 0) + 1
                    continue
                h.state = HEALTHY
                h.score = 0.0
                h.cooldown_s = 0.0
                out.append(self._record(
                    h, reason=f"canary job {job_id!r} completed clean"))
            if h.cordoned:
                # deferred cordon: the slot leaves service only now
                newly_cordoned[h.slice_index] = \
                    newly_cordoned.get(h.slice_index, 0) + 1
                continue
            if name not in self._free[h.slice_index]:
                self._free[h.slice_index].append(name)
                self._free[h.slice_index].sort()
        return newly_cordoned, out

    def reconcile(self, job_id: str,
                  placement: Dict[int, int]) -> Dict[int, int]:
        """A shrink/migration changed a job's per-slice counts: trim or
        extend the job's host set to match. Freed cordon-pending slots
        are returned as ``{slice: count}`` (same contract as
        ``release``); freed healthy hosts re-enter the pool."""
        hosts = self.assigned.get(job_id)
        if hosts is None:
            return {}
        want = {int(i): int(n) for i, n in placement.items()}
        by_slice: Dict[int, List[str]] = {}
        for name in hosts:
            by_slice.setdefault(slice_of(name), []).append(name)
        newly_cordoned: Dict[int, int] = {}
        kept: List[str] = []
        for i in sorted(set(by_slice) | set(want)):
            have = by_slice.get(i, [])
            need = want.get(i, 0)
            # Free cordon-pending hosts FIRST — a shrink is the fastest
            # way to get a sick slot out of a live gang.
            have.sort(key=lambda n: (not self.hosts[n].cordoned, n))
            while len(have) > need:
                name = have.pop(0)
                h = self.hosts[name]
                if h.cordoned:
                    newly_cordoned[i] = newly_cordoned.get(i, 0) + 1
                else:
                    self._free[i].append(name)
                    self._free[i].sort()
            while len(have) < need and self._free[i]:
                have.append(self._free[i].pop(0))
            kept.extend(sorted(have))
        self.assigned[job_id] = kept
        return newly_cordoned

    # -- journal round-trip ----------------------------------------------
    def _record(self, h: HostHealth, reason: str) -> Dict[str, Any]:
        """A journal-ready REC_FLEET_HEALTH payload for the host's
        CURRENT state (self-contained: carries its own evidence so
        `tony-tpu check` audits quarantines without cross-referencing)."""
        return {"host": h.host, "slice": h.slice_index, "state": h.state,
                "score": round(h.score, 4), "reason": reason,
                "manual": bool(h.manual),
                "cooldown_s": round(h.cooldown_s, 1),
                "evidence": list(h.evidence)}

    def apply_record(self, rec: Dict[str, Any], now: float) -> None:
        """Recovery: fold one replayed REC_FLEET_HEALTH record
        (last-wins per host). Free-pool membership is recomputed by the
        caller AFTER adoption re-books running jobs' hosts."""
        h = self.hosts.get(str(rec.get("host", "") or ""))
        if h is None:
            return
        h.state = str(rec.get("state", HEALTHY) or HEALTHY)
        h.score = float(rec.get("score", 0.0) or 0.0)
        h.manual = bool(rec.get("manual", False))
        h.cooldown_s = float(rec.get("cooldown_s", 0.0) or 0.0)
        h.evidence = [dict(e) for e in (rec.get("evidence") or [])
                      if isinstance(e, dict)]
        h.updated_mono = now
        if h.cordoned:
            h.cordoned_mono = now

    def resync_free(self) -> Dict[int, int]:
        """After recovery folds records + adoptions, drop cordoned
        hosts out of the free lists. Returns the per-slice count of
        free slots removed (the pool's cordon accounting delta)."""
        removed: Dict[int, int] = {}
        for h in self.hosts.values():
            if h.cordoned and h.host in self._free[h.slice_index]:
                self._free[h.slice_index].remove(h.host)
                removed[h.slice_index] = \
                    removed.get(h.slice_index, 0) + 1
        return removed


# ---------------------------------------------------------------------------
# preflight probe
# ---------------------------------------------------------------------------
def nvidia_device_nodes(dev_dir: str = "/dev") -> List[str]:
    """The NVIDIA device nodes on this host: the control node
    ``nvidiactl`` and one ``nvidia<N>`` per card (not ``nvidia-uvm`` or
    ``nvidia-modeset``, which are not cards)."""
    try:
        names = os.listdir(dev_dir)
    except OSError:
        return []
    cards = sorted((n for n in names
                    if n.startswith("nvidia") and n[6:].isdigit()),
                   key=lambda n: int(n[6:]))
    return [os.path.join(dev_dir, n)
            for n in (["nvidiactl"] if "nvidiactl" in names else []) + cards]


def preflight_probe(host: str, scratch_dir: str,
                    attach_device: bool = False) -> Optional[str]:
    """Cheap per-host go/no-go before a grant lands: an ephemeral port
    bind (the rendezvous contract), a durable scratch write (the
    journal/checkpoint contract), and — only when asked AND a device
    node exists — a device attach stat. Returns None when the host
    passes, else a one-line failure reason. The ``health.probe`` fault
    site (pinned per host via ``task:<host>``) rehearses the failure."""
    if faults.fire("health.probe", task_id=host):
        return "injected probe failure (health.probe)"
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind(("127.0.0.1", 0))
        finally:
            s.close()
    except OSError as e:
        return f"port bind failed: {e}"
    try:
        from tony_tpu_torch.utils.durable import atomic_write

        os.makedirs(scratch_dir, exist_ok=True)
        path = os.path.join(scratch_dir, f"probe-{host}.tmp")
        atomic_write(path, b'{"probe": "ok"}\n')
        os.unlink(path)
    except OSError as e:
        return f"durable scratch write failed: {e}"
    if attach_device:
        # Gated: only meaningful where an NVIDIA device node is visible;
        # absence is NOT a failure (CPU coordinators probe too).
        for dev in nvidia_device_nodes():
            if os.path.exists(dev) and not os.access(dev, os.R_OK):
                return f"device node {dev} exists but is unreadable"
    return None


# ---------------------------------------------------------------------------
# cordon file (fleet -> warm pool handshake)
# ---------------------------------------------------------------------------
def write_cordon_file(path: str, cordons: Dict[str, str]) -> None:
    """Atomically publish the cordon set (host -> state) where the
    warm-pool daemon can see it: a pool worker whose host is listed
    here must never be leased again. Takes a plain dict (snapshotted
    under the daemon lock) so the write itself runs lock-free."""
    from tony_tpu_torch.utils.durable import atomic_write

    atomic_write(path, (json.dumps(
        {"schema": 1, "hosts": dict(cordons)},
        sort_keys=True) + "\n").encode())


def read_cordoned(path: str) -> Dict[str, str]:
    """Tolerant read of a cordon file: absent/torn -> empty (an absent
    fleet means nothing is cordoned)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    hosts = doc.get("hosts") if isinstance(doc, dict) else None
    if not isinstance(hosts, dict):
        return {}
    return {str(k): str(v) for k, v in hosts.items()}
