"""Elastic entity re-sharding: re-plan the fleet instead of restarting it
(port of photon_ml_tpu/parallel/elastic.py).

The per-host streaming path (parallel/perhost_streaming.py) holds the
fleet's membership fixed. This module makes it a versioned, re-plannable
object:

  1. **detect**: every owner heartbeats into a shared fleet directory; a
     beat older than the deadline (``multihost.lost_hosts``), an
     operator-declared loss (``lost-hosts.json``) or an operator scale-up
     request (``scale-request.json``) produces a membership proposal (an
     atomic first-writer-wins file);
  2. **drain**: the streaming coordinates poll the monitor at their safe
     boundaries (the random effect's update entry, block boundaries and
     score entry; the fixed effects' update and score entry) and unwind
     with :class:`ReplanRequired`, a ``Preempted`` subclass, so coordinate
     descent's emergency checkpoint makes the finished work durable as for
     a preemption;
  3. **agree**: the ranks meet at a file barrier (fault site
     ``multihost.replan_barrier``; a barrier past its deadline falls back
     to supervised relaunch, logged, never a hang), exchange per-rank
     records, and each derives the same new plan
     (``EntityShardPlan.replan`` over the persisted block costs: no
     collective);
  4. **delta-transfer**: only the blocks whose physical owner changed move,
     as file copies between the ranks' block dirs (fault site
     ``io.block_transfer``). A copy that stays broken degrades to a
     per-block-cache fetch, then to a recorded cold rebuild whose bytes
     must match the original block's accounting;
  5. **re-base**: per-rank manifests, the plan sidecars, the spilled
     coefficients (files named by global block id, so a moved block's
     coefficients are one more copy) and the mid-epoch ``done_blocks``
     progress move onto the new plan version;
  6. **resume**: the descent goes on, bitwise a fresh run on the new
     topology (each block's solve is a function of its tensors, residuals
     and incoming coefficients, none of which depends on the topology).

Drains are local observations of the shared proposal file. The random
effect's update holds no collective, so every rank reaches the barrier from
any block boundary; regions with collectives (the fixed effects' updates,
the score merges) are entered only after an entry poll. A proposal that
lands between two ranks' entry polls of one such region leaves one rank in
a collective and the other at the barrier: the barrier's deadline turns
that race into the recorded supervised-relaunch fallback. A process that
dies can never ack the barrier either, so its cohort relaunches, and
:func:`relaunch_replan` re-plans the durable layout onto the new cohort
before the restore instead of re-ingesting.

The JSON files are the JAX package's bytes: each package reads the other's
membership, proposal and ack files. Numpy and the standard library only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.resilience import faults
from photon_ml_tpu_torch.resilience import preemption as _preemption

logger = logging.getLogger(__name__)

__all__ = [
    "ElasticError",
    "ElasticMonitor",
    "ElasticSession",
    "FleetMembership",
    "RelaunchReplanResult",
    "ReplanBarrierError",
    "ReplanRequired",
    "ReshardResult",
    "commit_membership",
    "declare_lost_hosts",
    "drain_if_replan_pending",
    "pending_proposal",
    "propose_membership",
    "read_membership",
    "relaunch_replan",
    "request_scale_up",
]

# the fleet directory's layout
MEMBERSHIP_FILE = "membership.json"
PROPOSALS_DIR = "proposals"
ACKS_DIR = "acks"
HEARTBEATS_DIR = "heartbeats"
LOST_HOSTS_FILE = "lost-hosts.json"
SCALE_REQUEST_FILE = "scale-request.json"


class ElasticError(RuntimeError):
    """A re-shard step that cannot proceed safely (the caller's recovery is
    the supervised relaunch)."""


class ReplanBarrierError(ElasticError):
    """The re-plan barrier did not complete within its deadline, or its
    entry fault survived retries: the fleet could not agree the new plan.
    Never retried in place; the recovery is the supervised relaunch,
    recorded by the caller."""


class ReplanRequired(_preemption.Preempted):
    """Raised at a safe drain boundary once a membership proposal is
    visible. A ``Preempted`` subclass, so coordinate descent's emergency
    checkpoint makes the finished work durable before the caller runs
    :meth:`ElasticSession.replan` and resumes."""

    def __init__(self, message: str, site: str = "block", partial=None,
                 proposal: Optional[dict] = None):
        super().__init__(message, site=site, partial=partial)
        self.proposal = proposal


# ---------------------------------------------------------------------------
# membership: the versioned fleet descriptor
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetMembership:
    """The versioned owner set of one training fleet.

    ``hosts`` are logical owner ids, the unit of elasticity; ``binding``
    maps each to the physical rank that runs its blocks. In production the
    binding is the identity; a harness binds several logical owners to one
    rank, so membership changes while the process group lives on. The plan
    assigns blocks to logical owners; everything physical (routing, block
    dirs, transfers) goes through the binding."""

    version: int
    hosts: List[int]
    binding: Dict[int, int]

    def __post_init__(self):
        self.version = int(self.version)
        self.hosts = sorted(int(h) for h in self.hosts)
        self.binding = {int(k): int(v) for k, v in self.binding.items()}
        missing = [h for h in self.hosts if h not in self.binding]
        if missing:
            raise ValueError(f"membership v{self.version} hosts {missing} have no physical "
                             "binding")

    @classmethod
    def initial(cls, num_hosts: int) -> "FleetMembership":
        """v1: one logical owner per rank, bound to itself (the plans built
        under it are the un-versioned ones, byte for byte)."""
        return cls(version=1, hosts=list(range(num_hosts)),
                   binding={h: h for h in range(num_hosts)})

    def physical_of(self, host: int) -> int:
        return self.binding[int(host)]

    def physical_owners(self, owners: np.ndarray) -> np.ndarray:
        """(B,) logical owner ids -> (B,) physical ranks."""
        owners = np.asarray(owners, np.int64)
        # sized past both the binding and the queried ids, so an owner above
        # the largest bound host reaches the diagnostic below
        hi = max(max(self.binding, default=0), int(owners.max()) if owners.size else 0)
        table = np.full(hi + 1, -1, np.int32)
        for h, p in self.binding.items():
            table[h] = p
        phys = table[owners]
        if (phys < 0).any():
            bad = sorted(set(owners[phys < 0].tolist()))
            raise ValueError(f"plan owners {bad} are not in membership v{self.version}")
        return phys.astype(np.int32)

    def my_hosts(self, process_id: int) -> List[int]:
        return [h for h in self.hosts if self.binding[h] == int(process_id)]

    def without(self, lost: Sequence[int]) -> "FleetMembership":
        lost_set = {int(h) for h in lost}
        survivors = [h for h in self.hosts if h not in lost_set]
        if not survivors:
            raise ElasticError(f"membership v{self.version}: losing {sorted(lost_set)} would "
                               "leave no owners — nothing to re-plan onto")
        return FleetMembership(version=self.version + 1, hosts=survivors,
                               binding={h: self.binding[h] for h in survivors})

    def with_added(self, added: Dict[int, int]) -> "FleetMembership":
        hosts, binding = list(self.hosts), dict(self.binding)
        for h, p in added.items():
            if int(h) in binding:
                raise ElasticError(f"membership v{self.version}: host {h} already present")
            hosts.append(int(h))
            binding[int(h)] = int(p)
        return FleetMembership(version=self.version + 1, hosts=hosts, binding=binding)

    def to_meta(self) -> dict:
        return {"version": self.version, "hosts": list(self.hosts),
                "binding": {str(h): p for h, p in self.binding.items()}}

    @classmethod
    def from_meta(cls, meta: dict) -> "FleetMembership":
        return cls(version=int(meta["version"]), hosts=[int(h) for h in meta["hosts"]],
                   binding={int(h): int(p) for h, p in meta["binding"].items()})


# ---------------------------------------------------------------------------
# the fleet directory's coordination files
# ---------------------------------------------------------------------------


def _atomic_write_json(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def read_membership(fleet_dir: str) -> Optional[FleetMembership]:
    """The committed membership, None before the first commit. Fault site
    ``multihost.membership`` (op=read), retried under the I/O policy."""
    path = os.path.join(fleet_dir, MEMBERSHIP_FILE)

    def read_once() -> Optional[dict]:
        faults.inject("multihost.membership", op="read", path=path)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    meta = resilience.call_with_retry(read_once, resilience.current_config().io_policy,
                                      describe="membership read")
    return FleetMembership.from_meta(meta) if meta is not None else None


def commit_membership(fleet_dir: str, membership: FleetMembership) -> str:
    """Atomically commit the agreed membership (fault site
    ``multihost.membership``, op=commit, retried)."""
    path = os.path.join(fleet_dir, MEMBERSHIP_FILE)

    def write_once() -> None:
        faults.inject("multihost.membership", op="commit", version=membership.version,
                      path=path)
        _atomic_write_json(path, membership.to_meta())

    resilience.call_with_retry(write_once, resilience.current_config().io_policy,
                               describe=f"membership v{membership.version} commit")
    return path


def _proposal_path(fleet_dir: str, version: int) -> str:
    return os.path.join(fleet_dir, PROPOSALS_DIR, f"proposal-v{version}.json")


def propose_membership(fleet_dir: str, new: FleetMembership, reason: str) -> dict:
    """Publish a membership proposal, first writer wins (a hard link of a
    private temp file): two ranks that see one loss together agree on one
    proposal, the loser reads the winner's file back."""
    path = _proposal_path(fleet_dir, new.version)
    payload = dict(new.to_meta(), reason=reason, proposed_at=time.time())
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    try:
        os.link(tmp, path)
    except FileExistsError:
        pass  # a peer proposed first; its file is the proposal
    finally:
        os.unlink(tmp)
    with open(path) as f:
        return json.load(f)


def pending_proposal(fleet_dir: str, current_version: int) -> Optional[dict]:
    """The next version's proposal if one is published (a stat and a read,
    polled at every drain boundary)."""
    path = _proposal_path(fleet_dir, current_version + 1)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # mid-publish; the next poll sees the whole file


def declare_lost_hosts(fleet_dir: str, hosts: Sequence[int],
                       reason: str = "operator-declared loss") -> None:
    """Operator entry point: declare owners lost without waiting for the
    heartbeat deadline. The re-plan that removes every declared host
    archives the file, so a later scale-up may re-add them."""
    _atomic_write_json(os.path.join(fleet_dir, LOST_HOSTS_FILE),
                       {"hosts": [int(h) for h in hosts], "reason": reason})


def request_scale_up(fleet_dir: str, added: Dict[int, int],
                     reason: str = "operator scale-up") -> None:
    """Operator entry point: fold new owners ``{logical: physical}`` into
    the plan at the fleet's next drain. The re-plan that adds every
    requested host archives the file; a binding outside the live cohort is
    refused (its blocks would have no rank)."""
    _atomic_write_json(os.path.join(fleet_dir, SCALE_REQUEST_FILE),
                       {"add": {str(h): int(p) for h, p in added.items()}, "reason": reason})


# ---------------------------------------------------------------------------
# the monitor (detect, propose, drain)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ElasticMonitor:
    """Polled at the streaming coordinates' safe boundaries: writes this
    rank's owner heartbeats, detects membership changes (a peer's beat past
    the deadline, an operator-declared loss, a scale-up request), publishes
    the proposal and reports any pending one so the caller drains.

    ``poll`` is local, no collective, so it is safe at boundaries the ranks
    reach different numbers of times."""

    fleet_dir: str
    membership: FleetMembership
    process_id: int = 0
    # the heartbeat loss deadline (seconds); None turns it off (the
    # operator files still work)
    heartbeat_deadline: Optional[float] = None
    min_poll_interval: float = 0.2
    # the live cohort's size: a scale-up binding owners outside
    # [0, num_processes) is refused before it is proposed (a published
    # proposal is never retracted). None skips the check.
    num_processes: Optional[int] = None
    clock: Callable[[], float] = time.time

    def __post_init__(self):
        os.makedirs(os.path.join(self.fleet_dir, HEARTBEATS_DIR), exist_ok=True)
        self._silenced: set = set()
        self._last_poll = -float("inf")
        self._last_beat = -float("inf")
        self._last_detect = -float("inf")
        self._started = self.clock()
        # every membership change restarts the grace window: an added owner
        # gets one deadline to beat, a re-added one's stale beat does not count
        self._membership_since = self._started

    def install_membership(self, membership: FleetMembership) -> None:
        """Adopt an agreed membership and restart the loss-detection grace
        window (the change counts as a fresh beat of every owner)."""
        self.membership = membership
        self._membership_since = self.clock()

    def silence_host(self, host: int) -> None:
        """Stop beating for one of this rank's logical owners: how a
        logical owner is lost while its rank lives on. Peers see it through
        the deadline."""
        self._silenced.add(int(host))

    def my_hosts(self) -> List[int]:
        return self.membership.my_hosts(self.process_id)

    def beat(self, step: Optional[int] = None) -> None:
        from photon_ml_tpu_torch.parallel import multihost

        for h in self.my_hosts():
            if h not in self._silenced:
                multihost.write_host_heartbeat(os.path.join(self.fleet_dir, HEARTBEATS_DIR), h,
                                               step=step)

    def _detect_lost(self, now: float) -> Tuple[List[int], str]:
        lost: List[int] = []
        reason = ""
        path = os.path.join(self.fleet_dir, LOST_HOSTS_FILE)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    declared = json.load(f)
                declared_hosts = [int(h) for h in declared.get("hosts", [])
                                  if int(h) in self.membership.hosts]
                if declared_hosts:
                    lost.extend(declared_hosts)
                    reason = declared.get("reason", "operator-declared loss")
            except (OSError, json.JSONDecodeError):
                pass
        if self.heartbeat_deadline is not None and (
                now - self._last_detect >= self.heartbeat_deadline / 5.0):
            # the ages scan reads every heartbeat file, so it runs on a
            # deadline-proportional throttle; the operator files are checked
            # at every poll
            self._last_detect = now
            from photon_ml_tpu_torch.parallel import multihost

            ages = multihost.read_heartbeat_ages(os.path.join(self.fleet_dir, HEARTBEATS_DIR))
            # the membership change is an implicit beat: cap every age at
            # the time under the current membership
            since_change = now - self._membership_since
            ages = {h: min(a, since_change) for h, a in ages.items()}
            # this rank's live owners are alive; its silenced ones are
            # judged by their stale beats like a peer's
            candidates = [h for h in self.membership.hosts
                          if not (h in self.my_hosts() and h not in self._silenced)]
            stale = multihost.lost_hosts(ages, candidates, self.heartbeat_deadline,
                                         missing_grace_elapsed=since_change)
            stale = [h for h in stale if h not in lost]
            if stale:
                lost.extend(stale)
                reason = (reason + "; " if reason else "") + (
                    f"heartbeat past {self.heartbeat_deadline:g}s deadline")
        return lost, reason

    def _detect_scale_up(self) -> Optional[Tuple[Dict[int, int], str]]:
        path = os.path.join(self.fleet_dir, SCALE_REQUEST_FILE)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                req = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        added = {int(h): int(p) for h, p in (req.get("add") or {}).items()
                 if int(h) not in self.membership.hosts}
        if self.num_processes is not None:
            bad = {h: p for h, p in added.items() if not 0 <= p < self.num_processes}
            if bad:
                # checked before publishing: a published proposal with a bad
                # binding would wedge every later re-plan
                logger.warning("ignoring scale-up request binding owners %s outside the live "
                               "cohort [0, %d) — fix scale-request.json", sorted(bad),
                               self.num_processes)
                added = {h: p for h, p in added.items() if h not in bad}
        if not added:
            return None  # already folded in, or an empty or invalid request
        return added, req.get("reason", "operator scale-up")

    def poll(self, step: Optional[int] = None, force: bool = False) -> Optional[dict]:
        """One throttled pass; returns the pending membership proposal (this
        poll's or a peer's) or None."""
        now = self.clock()
        if not force and now - self._last_poll < self.min_poll_interval:
            return None
        self._last_poll = now
        # beats need only land well inside the deadline
        beat_every = self.heartbeat_deadline / 3.0 if self.heartbeat_deadline else 1.0
        if force or now - self._last_beat >= beat_every:
            self._last_beat = now
            self.beat(step=step)
        prop = pending_proposal(self.fleet_dir, self.membership.version)
        if prop is not None:
            return prop
        lost, reason = self._detect_lost(now)
        if lost:
            try:
                survivors = self.membership.without(lost)
            except ElasticError as e:
                # a declaration naming every owner cannot re-plan: ignored,
                # logged, never raised past the drain machinery
                logger.warning("ignoring degenerate loss declaration %s: %s",
                               sorted(set(lost)), e)
                return None
            return propose_membership(self.fleet_dir, survivors,
                                      reason=f"lost owners {sorted(set(lost))}: {reason}")
        scale = self._detect_scale_up()
        if scale is not None:
            added, reason = scale
            return propose_membership(self.fleet_dir, self.membership.with_added(added),
                                      reason=f"scale-up owners {sorted(added)}: {reason}")
        return None


def drain_if_replan_pending(monitor, partial=None, where: str = "") -> None:
    """The coordinates' drain hook: poll the monitor (local, throttled) and
    unwind with :class:`ReplanRequired` if a proposal is pending.
    ``partial`` (a payload, or a zero-argument callable built only when a
    drain fires) carries the mid-epoch progress as a preemption does."""
    if monitor is None:
        return
    prop = monitor.poll()
    if prop is None:
        return
    if callable(partial):
        partial = partial()
    raise ReplanRequired(
        f"membership change proposed (v{prop['version']}"
        f"{': ' + prop['reason'] if prop.get('reason') else ''})"
        f"{' at ' + where if where else ''} — draining for re-plan",
        site="block", partial=partial, proposal=prop)


# ---------------------------------------------------------------------------
# the re-plan session (agree, delta-transfer, re-base)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReshardResult:
    """What one rank's re-plan produced."""

    membership: FleetMembership
    plan_version: int
    manifest: object  # the re-based PerHostStreamingManifest
    moved: List[Tuple[int, int, int]]  # (gid, old physical, new physical)
    incoming: List[int]  # gids copied or rebuilt onto this rank
    rebuilt: List[int]  # incoming gids that degraded to a cold rebuild
    blocks_total: int
    epoch: int  # the (possibly mid-flight) epoch the drain interrupted
    decisions: List[str] = dataclasses.field(default_factory=list)

    @property
    def blocks_moved(self) -> int:
        return len(self.moved)


def _copy_with_transfer_site(src: str, dst: str, gid: int, what: str) -> None:
    """One retried file copy under the ``io.block_transfer`` fault site
    (tmp + rename: a torn copy is never addressable)."""

    def copy_once() -> None:
        faults.inject("io.block_transfer", block=int(gid), what=what, src=src, dst=dst)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = f"{dst}.tmp-{os.getpid()}"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)

    resilience.call_with_retry(copy_once, resilience.current_config().io_policy,
                               describe=f"{what} transfer (block {gid})")


@dataclasses.dataclass
class ElasticSession:
    """One rank's handle on the re-plan protocol.

    ``num_processes`` is the physical cohort that must ack the barrier: a
    logical owner's loss keeps it, and a dead rank can never ack, which is
    how the deadline routes a process's death to the supervised relaunch."""

    fleet_dir: str
    process_id: int
    num_processes: int
    monitor: ElasticMonitor
    barrier_timeout: float = 60.0
    # a per-block tensor cache (unscoped: block content is the same on any
    # topology) read when a peer copy stays broken
    block_cache: Optional[object] = None
    block_key_base: Optional[str] = None

    def __post_init__(self):
        self._pending: Optional[dict] = None

    def replan_prepare(self, manifest, proposal: dict, *, state_dir=None, epoch: int = 0,
                       rebuild_block: Optional[Callable[[int], dict]] = None,
                       ledger: Optional[dict] = None) -> None:
        """Publish this rank's re-plan record for the proposed version: its
        block dir, its live spill dirs and per-block metadata (split from
        :meth:`replan_finish` so one process can drive a simulated fleet).
        ``ledger`` (the coordinate's ``ledger_export()``) rides the record,
        so every rank merges one ledger, balances the new plan on the
        realized per-block costs and re-bases each moved block's entry."""
        from photon_ml_tpu_torch.parallel.perhost_streaming import EntityShardPlan

        new_mem = FleetMembership.from_meta(proposal)
        bad_phys = sorted({p for p in new_mem.binding.values()
                           if not 0 <= p < self.num_processes})
        if bad_phys:
            # no rank would host such an owner's blocks: nobody copies them
            # and training would drop their entities
            raise ElasticError(
                f"proposal v{new_mem.version} binds owners to physical processes {bad_phys} "
                f"outside the live cohort [0, {self.num_processes}) — blocks bound there would "
                "be silently orphaned; fix the scale request's binding")
        cur = self.monitor.membership
        if new_mem.version != cur.version + 1:
            raise ElasticError(
                f"proposal v{new_mem.version} does not follow membership v{cur.version} — a "
                "missed re-plan needs the supervised-relaunch path (restore re-plans from the "
                "checkpoint)")
        old_plan = EntityShardPlan.from_sidecars(manifest.dir)
        if old_plan is None:
            raise ElasticError(f"{manifest.dir} has no plan sidecar — manifests built before "
                               "plan versioning cannot re-plan in flight")
        if old_plan.version != cur.version:
            raise ElasticError(f"plan sidecar v{old_plan.version} does not match membership "
                               f"v{cur.version}")
        owned = [int(g) for g in manifest.global_block_ids]
        # one entry per live spill dir (the coordinate's
        # replan_state_dirs()), matched across ranks by dir name (epoch-N,
        # init): the descent steps in lockstep
        if state_dir is None:
            state_dirs: List[str] = []
        elif isinstance(state_dir, (str, os.PathLike)):
            state_dirs = [os.fspath(state_dir)]
        else:
            state_dirs = [os.fspath(d) for d in state_dir]
        state_entries = []
        for d in state_dirs:
            gids = ([g for g in owned if os.path.exists(os.path.join(d, f"coefs-g{g:05d}.npy"))]
                    if os.path.isdir(d) else [])
            state_entries.append({"name": os.path.basename(os.path.abspath(d)),
                                  "dir": os.path.abspath(d), "gids": [int(g) for g in gids]})
        record = {
            "process": int(self.process_id),
            "block_dir": os.path.abspath(manifest.dir),
            "state_dirs": state_entries,
            "epoch": int(epoch),
            "owned_old": owned,
            "blocks_meta": {str(g): m for g, m in zip(owned, manifest.blocks)},
        }
        if ledger:
            record["ledger"] = {str(g): dict(e) for g, e in ledger.items()}
        _atomic_write_json(self._ack_path(new_mem.version, "json"), record)
        self._pending = {"proposal": proposal, "new_mem": new_mem, "manifest": manifest,
                         "old_plan": old_plan, "record": record, "epoch": int(epoch),
                         "state_dirs": state_dirs, "rebuild_block": rebuild_block}

    def _ack_path(self, version: int, kind: str, process: Optional[int] = None) -> str:
        p = self.process_id if process is None else process
        return os.path.join(self.fleet_dir, ACKS_DIR, f"v{version}", f"host-{p}.{kind}")

    def _wait_all(self, version: int, kind: str, describe: str) -> None:
        deadline = time.monotonic() + self.barrier_timeout
        while True:
            missing = [q for q in range(self.num_processes)
                       if not os.path.exists(self._ack_path(version, kind, q))]
            if not missing:
                return
            if time.monotonic() > deadline:
                raise ReplanBarrierError(
                    f"re-plan {describe} barrier (v{version}) timed out after "
                    f"{self.barrier_timeout:g}s waiting for physical processes {missing} — a "
                    "peer is wedged, dead, or never drained (check the owner heartbeat ages); "
                    "falling back to supervised relaunch is the recovery path")
            time.sleep(0.05)

    def replan_finish(self) -> ReshardResult:
        from photon_ml_tpu_torch.algorithm.streaming_random_effect import write_block_file
        from photon_ml_tpu_torch.optim.convergence import ConvergenceLedger
        from photon_ml_tpu_torch.parallel.perhost_streaming import (
            PerHostStreamingManifest,
            commit_perhost_manifest,
        )

        if self._pending is None:
            raise ElasticError("replan_finish without replan_prepare")
        ctx, self._pending = self._pending, None
        new_mem: FleetMembership = ctx["new_mem"]
        old_mem = self.monitor.membership
        manifest, old_plan = ctx["manifest"], ctx["old_plan"]

        # ---- the agreement barrier (deadline-bound, fault-injectable) -----
        try:
            resilience.call_with_retry(
                lambda: faults.inject("multihost.replan_barrier", version=new_mem.version,
                                      process=self.process_id),
                resilience.current_config().io_policy,
                describe=f"re-plan barrier v{new_mem.version}")
        except resilience.RetryError as e:
            raise ReplanBarrierError(
                f"re-plan barrier v{new_mem.version} entry failed after retries: {e} — "
                "falling back to supervised relaunch") from e
        self._wait_all(new_mem.version, "json", "record")
        records: Dict[int, dict] = {}
        for q in range(self.num_processes):
            with open(self._ack_path(new_mem.version, "json", q)) as f:
                records[q] = json.load(f)

        # ---- the new plan: EntityShardPlan.replan, balanced on the merged
        # ledger's realized costs when any record carries one --------------
        merged_ledger = None
        if any(r.get("ledger") for r in records.values()):
            merged_ledger = ConvergenceLedger()
            for q in sorted(records):
                merged_ledger.merge({int(g): e for g, e in
                                     (records[q].get("ledger") or {}).items()})
        new_plan = old_plan.replan(
            new_mem.hosts, version=new_mem.version,
            observed_costs=merged_ledger.observed_costs() if merged_ledger else None)
        blocking_verdict = None
        if merged_ledger is not None:
            # owner balancing cannot fix a realized imbalance past the
            # re-block threshold: surface the planner's verdict
            from photon_ml_tpu_torch.compile.cost import CostModel

            blocking_verdict = CostModel().reblock_recommendation(merged_ledger.observed_costs())
        moved = old_plan.moved_blocks(new_plan, old_mem, new_mem)
        old_phys = old_mem.physical_owners(old_plan.owners)
        new_phys = new_mem.physical_owners(new_plan.owners)
        n_blocks = len(new_plan.owners)
        incoming = [g for g, _, np_ in moved if np_ == self.process_id]

        # ---- delta transfer: block payload files ---------------------------
        my_dir = ctx["record"]["block_dir"]
        blocks_meta: Dict[int, dict] = {int(g): m for g, m in
                                        zip(ctx["record"]["owned_old"], manifest.blocks)}
        rebuilt: List[int] = []
        decisions: List[str] = []
        for g in incoming:
            src_rec = records[int(old_phys[g])]
            meta = src_rec["blocks_meta"].get(str(g))
            if meta is None:
                raise ElasticError(f"block {g}: old owner process {int(old_phys[g])} has no "
                                   "metadata for it — plan sidecars disagree")
            fname = meta["file"]
            try:
                _copy_with_transfer_site(os.path.join(src_rec["block_dir"], fname),
                                         os.path.join(my_dir, fname), g, what="block")
            except resilience.RetryError as copy_err:
                got = self._fetch_from_block_cache(g)
                if got is None:
                    if ctx["rebuild_block"] is None:
                        raise ElasticError(
                            f"block {g} transfer failed after retries ({copy_err}) and no "
                            "rebuild_block callback is available — refusing to continue with a "
                            "missing block") from copy_err
                    got = ctx["rebuild_block"](g)
                    decisions.append(f"block {g}: transfer failed after retries ({copy_err}); "
                                     "degraded to a cold rebuild")
                else:
                    decisions.append(f"block {g}: transfer failed after retries ({copy_err}); "
                                     "served from the per-block tensor cache")
                new_meta = write_block_file(my_dir, fname, got)
                if new_meta != meta:
                    raise ElasticError(
                        f"block {g}: cold-rebuilt payload accounting {new_meta} does not match "
                        f"the original {meta} — refusing to serve a divergent block")
                rebuilt.append(g)
            blocks_meta[g] = meta

        # ---- delta transfer: spilled coefficients, every live spill dir the
        # peers listed, matched by dir name --------------------------------
        my_state_dirs = ctx["state_dirs"]
        if my_state_dirs:
            my_root = os.path.dirname(os.path.abspath(my_state_dirs[0]))
            prev_owned = set(ctx["record"]["owned_old"])
            for g in incoming:
                if g in prev_owned:
                    continue
                src_rec = records[int(old_phys[g])]
                fname = f"coefs-g{g:05d}.npy"
                for entry in src_rec.get("state_dirs") or []:
                    if g not in set(entry["gids"]):
                        continue  # never written there: zeros by design
                    try:
                        _copy_with_transfer_site(os.path.join(entry["dir"], fname),
                                                 os.path.join(my_root, entry["name"], fname),
                                                 g, what="state")
                    except resilience.RetryError as e:
                        # coefficients are training state: no rebuild keeps
                        # the run bitwise, so the supervised relaunch takes over
                        raise ElasticError(
                            f"block {g} coefficient-state transfer failed after retries ({e}); "
                            "resuming without it would silently zero trained coefficients — "
                            "fall back to supervised relaunch") from e

        # ---- re-base the manifest and plan sidecars -------------------------
        new_owned = [g for g in range(n_blocks) if int(new_phys[g]) == self.process_id]
        commit_perhost_manifest(
            my_dir, [blocks_meta[g] for g in new_owned], manifest, owned_gids=new_owned,
            owners=new_plan.owners, block_of=new_plan.block_of_vocab,
            plan_version=new_mem.version, membership=new_mem, block_costs=new_plan.block_costs,
            fe_chunk_owners=new_plan.fe_chunk_owners, fe_chunk_costs=new_plan.fe_chunk_costs)
        if merged_ledger is not None:
            # each rank's sidecar holds its new blocks' entries: a moved
            # block's skip streak survives the move
            rebased = ConvergenceLedger()
            rebased.merge({g: e for g in new_owned for e in [merged_ledger.entry(g)]
                           if e is not None})
            rebased.save(my_dir)

        # ---- the done barrier: no rank resumes (and collects epochs) while a
        # peer still copies from its dirs -----------------------------------
        _atomic_write_json(self._ack_path(new_mem.version, "done"),
                           {"process": self.process_id, "done_at": time.time()})
        self._wait_all(new_mem.version, "done", "transfer-done")

        # ---- the commit, after every rank's layout reached the new version:
        # a failure before it leaves membership.json at the old version ----
        if self.process_id == 0:
            commit_membership(self.fleet_dir, new_mem)
            # archive the satisfied operator files before anyone polls
            # again: a stale one would re-propose forever
            self._consume_operator_files(new_mem)
            _atomic_write_json(self._ack_path(new_mem.version, "committed"),
                               {"process": self.process_id, "committed_at": time.time()})
        else:
            deadline = time.monotonic() + self.barrier_timeout
            commit_path = self._ack_path(new_mem.version, "committed", 0)
            while not os.path.exists(commit_path):
                if time.monotonic() > deadline:
                    raise ReplanBarrierError(
                        f"membership v{new_mem.version} commit marker did not appear within the "
                        "deadline — process 0 died between the done barrier and the commit; "
                        "falling back to supervised relaunch")
                time.sleep(0.05)

        self.monitor.install_membership(new_mem)
        new_manifest = PerHostStreamingManifest.load(my_dir)
        reason = ctx["proposal"].get("reason", "membership change")
        decisions.insert(0, (
            f"shard plan re-planned to v{new_mem.version} ({reason}): {len(moved)}/{n_blocks} "
            f"blocks moved fleet-wide, {len(incoming)} onto process {self.process_id} "
            f"({len(rebuilt)} cold-rebuilt), hosts {new_mem.hosts}"))
        if blocking_verdict is not None:
            action, imbalance, why = blocking_verdict
            decisions.append(f"blocking: {action} (realized imbalance {imbalance:.2f}) — {why}")
        for d in decisions:
            logger.info("elastic re-shard: %s", d)
        return ReshardResult(membership=new_mem, plan_version=new_mem.version,
                             manifest=new_manifest, moved=moved, incoming=incoming,
                             rebuilt=rebuilt, blocks_total=n_blocks, epoch=ctx["epoch"],
                             decisions=decisions)

    def _consume_operator_files(self, new_mem: FleetMembership) -> None:
        """Archive (rename, not delete) the operator files the committed
        membership fully satisfies; a partly satisfied one stays and
        triggers the next re-plan."""
        lost_path = os.path.join(self.fleet_dir, LOST_HOSTS_FILE)
        try:
            with open(lost_path) as f:
                hosts = {int(h) for h in json.load(f).get("hosts", [])}
            if hosts and not (hosts & set(new_mem.hosts)):
                os.replace(lost_path, f"{lost_path}.consumed-v{new_mem.version}")
        except (OSError, json.JSONDecodeError):
            pass
        scale_path = os.path.join(self.fleet_dir, SCALE_REQUEST_FILE)
        try:
            with open(scale_path) as f:
                added = {int(h) for h in (json.load(f).get("add") or {})}
            if added and added <= set(new_mem.hosts):
                os.replace(scale_path, f"{scale_path}.consumed-v{new_mem.version}")
        except (OSError, json.JSONDecodeError):
            pass

    def _fetch_from_block_cache(self, gid: int) -> Optional[dict]:
        if self.block_cache is None or self.block_key_base is None:
            return None
        hit = self.block_cache.get(f"{self.block_key_base}-g{gid:05d}")
        if hit is None:
            return None
        return {k: np.asarray(v) for k, v in hit.arrays.items()}

    def replan(self, manifest, proposal: dict, *, state_dir=None, epoch: int = 0,
               rebuild_block: Optional[Callable[[int], dict]] = None,
               ledger: Optional[dict] = None) -> ReshardResult:
        """Agree, delta-transfer and re-base in one call. ``state_dir`` is a
        path or a sequence of paths (the coordinate's
        ``replan_state_dirs()``); ``ledger`` the coordinate's
        ``ledger_export()``."""
        self.replan_prepare(manifest, proposal, state_dir=state_dir, epoch=epoch,
                            rebuild_block=rebuild_block, ledger=ledger)
        return self.replan_finish()


# ---------------------------------------------------------------------------
# the relaunch-time re-plan (a supervised relaunch onto another cohort)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RelaunchReplanResult:
    """What one relaunched rank's offline re-plan produced."""

    plan: object  # the new EntityShardPlan (version + 1)
    membership: FleetMembership  # identity-bound over the new cohort
    manifest: object  # this rank's re-based PerHostStreamingManifest
    moved: List[Tuple[int, int, int]]  # (gid, old physical, new physical)
    adopted: List[int]  # gids whose block files were copied onto this rank
    state_files_adopted: int  # spilled coefficient files copied in
    decisions: List[str] = dataclasses.field(default_factory=list)


def relaunch_replan(coord_root: str, process_id: int, num_processes: int, *,
                    state_root_pairs: Sequence[Tuple[Dict[int, str], str]] = ()
                    ) -> RelaunchReplanResult:
    """Re-plan one streaming coordinate's durable layout onto a new cohort
    at relaunch, the path the live session cannot take (a dead rank never
    acks its barrier). Each rank runs it alone: the new plan is a function
    of the persisted sidecars and the cohort size, so every rank derives
    the same plan with no collective and copies only the block and state
    files it now owns.

    ``coord_root`` holds the prior cohort's ``process-<pid>`` manifest dirs.
    ``state_root_pairs`` lists ``({old rank: its spill root}, this rank's
    spill root)`` per coordinate state instance; an adopted block's
    ``coefs-g*.npy`` files are copied epoch dir by name, as the live re-base
    does, so the plan-versioned checkpoint restore finds them.

    Any failure raises (fault site ``multihost.relaunch_replan`` at entry):
    the caller records it and re-ingests everything."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        EntityShardPlan,
        PerHostStreamingManifest,
        commit_perhost_manifest,
        load_plan_sidecars,
    )

    faults.inject("multihost.relaunch_replan", process=int(process_id), root=coord_root)
    proc_dirs = {int(d.split("-", 1)[1]): os.path.join(coord_root, d)
                 for d in os.listdir(coord_root)
                 if d.startswith("process-")
                 and os.path.isfile(os.path.join(coord_root, d, "manifest.json"))}
    if not proc_dirs:
        raise ElasticError(f"{coord_root} has no prior process-<pid> manifest dirs — nothing to "
                           "re-plan from")
    # the newest committed plan is authoritative; its binding names the
    # prior cohort's dirs (a torn sidecar raises in load_plan_sidecars)
    versions = {pid: load_plan_sidecars(d)[0] for pid, d in proc_dirs.items()}
    if any(m is None for m in versions.values()):
        raise ElasticError(f"{coord_root} holds pre-versioned manifests (no plan.json) — "
                           "relaunch re-plan needs plan sidecars; re-ingest instead")
    vmax = max(int(m["version"]) for m in versions.values())
    auth_pid = min(pid for pid, m in versions.items() if int(m["version"]) == vmax)
    auth_meta = versions[auth_pid]
    old_mem = FleetMembership(version=vmax, hosts=[int(h) for h in auth_meta["hosts"]],
                              binding={int(h): int(q) for h, q in auth_meta["binding"].items()})
    old_cohort = sorted(set(old_mem.binding.values()))
    stale = [q for q in old_cohort if q not in versions or int(versions[q]["version"]) != vmax]
    if stale:
        raise ElasticError(
            f"prior cohort processes {stale} have missing or stale plan sidecars (expected "
            f"v{vmax}) — a re-shard crashed mid-commit; re-ingest instead of resuming from mixed "
            "plan versions")
    old_plan = EntityShardPlan.from_sidecars(proc_dirs[auth_pid])
    new_mem = FleetMembership(version=vmax + 1, hosts=list(range(int(num_processes))),
                              binding={h: h for h in range(int(num_processes))})
    new_plan = old_plan.replan(new_mem.hosts, version=new_mem.version)
    moved = old_plan.moved_blocks(new_plan, old_mem, new_mem)
    old_phys = old_mem.physical_owners(old_plan.owners)
    new_phys = new_mem.physical_owners(new_plan.owners)
    new_owned = [g for g in range(len(new_plan.owners)) if int(new_phys[g]) == int(process_id)]
    my_dir = os.path.join(coord_root, f"process-{int(process_id)}")
    os.makedirs(my_dir, exist_ok=True)

    # block metadata by gid, from the prior manifests that owned them
    blocks_meta: Dict[int, dict] = {}
    for pid in old_cohort:
        with open(os.path.join(proc_dirs[pid], "manifest.json")) as f:
            m = json.load(f)
        for g, meta in zip(m["global_block_ids"], m["blocks"]):
            blocks_meta[int(g)] = meta

    adopted: List[int] = []
    state_copied = 0
    for g in new_owned:
        meta = blocks_meta.get(g)
        if meta is None:
            raise ElasticError(f"block {g}: no prior manifest records it — plan sidecars and "
                               "manifests disagree; re-ingest instead")
        src_pid = int(old_phys[g])
        dst = os.path.join(my_dir, meta["file"])
        if src_pid != int(process_id) or not os.path.exists(dst):
            _copy_with_transfer_site(os.path.join(proc_dirs[src_pid], meta["file"]), dst, g,
                                     what="block")
            adopted.append(g)
            # the spilled coefficients ride along: the same file name, in
            # every epoch dir of the old owner's live spill roots
            fname = f"coefs-g{g:05d}.npy"
            for src_by_pid, dst_root in state_root_pairs:
                src_root = src_by_pid.get(src_pid)
                if src_root is None or not os.path.isdir(src_root):
                    continue
                for sub in sorted(os.listdir(src_root)):
                    src = os.path.join(src_root, sub, fname)
                    if os.path.isfile(src):
                        _copy_with_transfer_site(src, os.path.join(dst_root, sub, fname), g,
                                                 what="state")
                        state_copied += 1

    base = dataclasses.replace(PerHostStreamingManifest.load(proc_dirs[auth_pid]),
                               process_index=int(process_id), num_processes=int(num_processes))
    commit_perhost_manifest(
        my_dir, [blocks_meta[g] for g in new_owned], base, owned_gids=new_owned,
        owners=new_plan.owners, block_of=new_plan.block_of_vocab, plan_version=new_mem.version,
        membership=new_mem, block_costs=new_plan.block_costs,
        fe_chunk_owners=new_plan.fe_chunk_owners, fe_chunk_costs=new_plan.fe_chunk_costs)
    decisions = [
        f"relaunch re-plan {coord_root}: v{vmax} cohort {old_cohort} -> v{new_mem.version} "
        f"cohort {sorted(set(new_mem.binding.values()))}; {len(moved)}/{len(new_plan.owners)} "
        f"blocks moved fleet-wide, {len(adopted)} adopted onto process {int(process_id)} "
        f"({state_copied} coefficient-state files), no re-ingest"]
    for d in decisions:
        logger.info("relaunch re-plan: %s", d)
    return RelaunchReplanResult(plan=new_plan, membership=new_mem,
                                manifest=PerHostStreamingManifest.load(my_dir), moved=moved,
                                adopted=adopted, state_files_adopted=state_copied,
                                decisions=decisions)
