"""Multi-process bring-up, per-host ingest bookkeeping, global blocks and
coordinator-gated side effects (port of photon_ml_tpu/parallel/multihost.py).

Every process runs the SAME program: it reads only its slice of the input
(:meth:`MultihostContext.host_shard_paths` / ``host_row_slice``), holds
only its block of every row- or entity-sharded tensor, and meets the
others in the collectives of :class:`~photon_ml_tpu_torch.parallel.mesh.
MeshContext`. One process drives one device (its rank IS the device's
place in the JAX package's process-major order).

Bring-up (:func:`initialize`): the three ``--multihost-*`` flags give the
coordinator address (``HOST:PORT``, or a ``tcp://``/``file://`` URL), the
world size and this process's rank; ``torch.distributed`` brings the group
up there. Without them a world of one comes up on an in-process store.
Before the group comes up every rank publishes its host name and card count
on the rendezvous store, so the backend follows the whole job's topology:
NCCL when each rank has a card of its own, gloo when several ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU; each rank
takes the card of its place on its host. A failed bring-up raises; the group's timeout
bounds every collective, so a rank that dies cannot leave the others
blocked forever.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.parallel.mesh import DATA_AXIS, MeshContext

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

#: Env override for the barrier deadline (seconds; 0/unset = no deadline).
BARRIER_TIMEOUT_ENV = "PHOTON_BARRIER_TIMEOUT"
#: Env override for the process group's collective timeout (seconds).
COLLECTIVE_TIMEOUT_ENV = "PHOTON_COLLECTIVE_TIMEOUT"
DEFAULT_COLLECTIVE_TIMEOUT_S = 1800.0

HEARTBEAT_PREFIX = "heartbeat-"

BACKENDS = ("nccl", "gloo")


class BarrierTimeoutError(OSError):
    """A barrier did not complete within its deadline: an infinite hang
    behind a wedged process becomes a diagnosable failure (read the
    per-host heartbeat ages). Never retried by :meth:`MultihostContext.
    barrier` itself: the abandoned wait is still parked in the collective,
    and re-entering it would desynchronize barrier order across ranks."""


def resolve_barrier_timeout(timeout: Optional[float]) -> Optional[float]:
    """Effective barrier deadline: an explicit value wins; ``None`` falls
    back to ``PHOTON_BARRIER_TIMEOUT``; 0/absent means no deadline."""
    if timeout is not None:
        return timeout if timeout > 0 else None
    raw = os.environ.get(BARRIER_TIMEOUT_ENV)
    if not raw:
        return None
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(f"{BARRIER_TIMEOUT_ENV} must be a number of seconds, got {raw!r}")
    return val if val > 0 else None


def _call_with_deadline(fn, timeout: float, describe: str) -> None:
    """Run ``fn`` on a worker thread, raising :class:`BarrierTimeoutError`
    if it does not return within ``timeout`` seconds. The hung worker is a
    daemon and is left behind: a blocked collective can be diagnosed, not
    cancelled."""
    done = threading.Event()
    box: List[BaseException] = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — crossing the thread boundary; re-raised below
            box.append(e)
        finally:
            done.set()

    t = threading.Thread(target=run, name=f"barrier-{describe}", daemon=True)
    t.start()
    if not done.wait(timeout):
        raise BarrierTimeoutError(
            f"{describe} did not complete within {timeout:g}s — a peer process "
            "is likely wedged, preempted, or dead; check the per-host heartbeat "
            "ages in the coordinator log"
        )
    if box:
        raise box[0]


def write_host_heartbeat(directory: str, host_id: int, step: Optional[int] = None) -> str:
    """Atomic heartbeat write for one host id (tmp + rename through the
    retry machinery, fault site ``multihost.heartbeat``)."""
    from photon_ml_tpu_torch import resilience
    from photon_ml_tpu_torch.resilience import faults

    path = os.path.join(directory, f"{HEARTBEAT_PREFIX}{int(host_id)}.json")

    def write_once() -> None:
        faults.inject("multihost.heartbeat", process=int(host_id), path=path)
        os.makedirs(directory, exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump({"process": int(host_id), "time": time.time(), "step": step}, f)
        os.replace(path + ".tmp", path)

    resilience.call_with_retry(write_once, resilience.current_config().io_policy,
                               describe=f"heartbeat host {host_id}")
    return path


def read_heartbeat_ages(directory: str) -> Dict[int, float]:
    """host id -> seconds since its last heartbeat (hosts that never beat
    are absent). Unreadable beats are logged and skipped."""
    ages: Dict[int, float] = {}
    if not os.path.isdir(directory):
        return ages
    now = time.time()
    for name in sorted(os.listdir(directory)):
        if not name.startswith(HEARTBEAT_PREFIX) or not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                payload = json.load(f)
            ages[int(payload["process"])] = now - float(payload["time"])
        except (OSError, ValueError, KeyError) as e:
            logger.warning("unreadable heartbeat %s: %s", name, e)
    return ages


def lost_hosts(ages: Dict[int, float], expected: Sequence[int], deadline: float,
               missing_grace_elapsed: Optional[float] = None) -> List[int]:
    """The expected hosts whose last beat is older than ``deadline``
    seconds. A host that never beat counts as lost only once
    ``missing_grace_elapsed`` (the observer's uptime) passes the deadline,
    so a slow starter is not declared dead at the first poll."""
    lost: List[int] = []
    for h in sorted(int(x) for x in expected):
        age = ages.get(h)
        if age is None:
            if missing_grace_elapsed is not None and missing_grace_elapsed > deadline:
                lost.append(h)
        elif age > deadline:
            lost.append(h)
    return lost


def _init_method(address: str) -> str:
    if address.startswith(("tcp://", "file://", "env://")):
        return address
    return f"tcp://{address}"


@dataclasses.dataclass(frozen=True)
class RankPlace:
    """Where one rank runs: its host's name, the host's card count and the
    device type it asked for. Every rank publishes its own at rendezvous."""

    host: str
    cards: int
    device_type: str


TOPOLOGY_PREFIX = "photon-topology"


def exchange_topology(store, rank: int, world: int, place: RankPlace) -> List[RankPlace]:
    """Every rank's place, in rank order: each rank writes its own to the
    rendezvous store and waits for the others' (the store's timeout bounds
    the wait). Called by every rank before the group comes up."""
    import torch.distributed as dist

    ns = dist.PrefixStore(TOPOLOGY_PREFIX, store)
    ns.set(str(rank), json.dumps(dataclasses.asdict(place)))
    keys = [str(r) for r in range(world)]
    ns.wait(keys)
    return [RankPlace(**json.loads(ns.get(k).decode())) for k in keys]


def local_rank(topology: Sequence[RankPlace], rank: int) -> int:
    """This rank's place among the ranks on its host (rank order)."""
    host = topology[rank].host
    return sum(1 for p in topology[:rank] if p.host == host)


def choose_backend(topology: Sequence[RankPlace]) -> str:
    """NCCL when every rank runs on a card and no host holds more ranks
    than cards; gloo when ranks share a card (NCCL refuses two ranks on one
    device) or any rank runs on the CPU. Every rank sees the same topology,
    so every rank picks the same backend."""
    if any(p.device_type != "cuda" for p in topology):
        return "gloo"
    ranks: Dict[str, int] = {}
    for p in topology:
        ranks[p.host] = ranks.get(p.host, 0) + 1
    return "nccl" if all(ranks[p.host] <= p.cards for p in topology) else "gloo"


def rank_device(device: Optional[str], local: int) -> torch.device:
    """This rank's device: the card ``LOCAL_RANK`` (default its place on
    its host) modulo the host's card count, or the CPU when asked for."""
    from photon_ml_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", local))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def collective_timeout() -> datetime.timedelta:
    raw = os.environ.get(COLLECTIVE_TIMEOUT_ENV)
    return datetime.timedelta(seconds=float(raw) if raw else DEFAULT_COLLECTIVE_TIMEOUT_S)


# the group this module brought up (torn down by shutdown())
_OWNED = {"group": False}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[str] = None,
               backend: Optional[str] = None) -> "MultihostContext":
    """Bring up the process group (idempotent) and return this process's
    context. With no coordinator a world of one comes up on an in-process
    store. The ranks meet at the coordinator's store first and publish
    their hosts, so the backend and each rank's card follow the whole
    job's topology; ``backend`` forces one. Every failure to bring the
    group up raises."""
    import socket

    import torch.distributed as dist

    from photon_ml_tpu_torch.device import resolve_device

    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside a world of {world}")
    if world > 1 and not coordinator_address:
        raise ValueError("a world of more than one process needs --multihost-coordinator")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise ValueError(
                f"a process group of {dist.get_world_size()} ranks (this rank "
                f"{dist.get_rank()}) is already up; asked for rank {rank} of {world}")
        dev = rank_device(device, rank)
    else:
        timeout = collective_timeout()
        if coordinator_address:
            store, _, _ = next(dist.rendezvous(_init_method(coordinator_address), rank, world,
                                               timeout=timeout))
            store.set_timeout(timeout)
        else:
            store = dist.HashStore()
        asked = resolve_device(device).type
        topology = exchange_topology(store, rank, world, RankPlace(
            socket.gethostname(), torch.cuda.device_count() if asked == "cuda" else 0, asked))
        dev = rank_device(device, local_rank(topology, rank))
        chosen = backend or choose_backend(topology)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kwargs = dict(backend=chosen, store=store, world_size=world, rank=rank, timeout=timeout)
        if chosen == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(**kwargs)
        _OWNED["group"] = True
    ctx = MeshContext(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev,
                      str(dist.get_backend()))
    return MultihostContext(process_id=ctx.rank, num_processes=ctx.world, mesh=ctx)


def shutdown() -> None:
    """Tear down the group :func:`initialize` brought up (a no-op for one
    it found already up)."""
    import torch.distributed as dist

    if _OWNED["group"] and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED["group"] = False


@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """This process's coordinates in the job, its mesh, and the global
    block bookkeeping."""

    process_id: int
    num_processes: int
    mesh: Optional[MeshContext] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    # -- topology ------------------------------------------------------
    def mesh_context(self, axis: str = DATA_AXIS) -> MeshContext:
        """The mesh over every rank (one device each, process-major)."""
        if self.mesh is None:
            return dataclasses.replace(MeshContext.local(), axis=axis)
        return dataclasses.replace(self.mesh, axis=axis)

    # -- per-host ingest -----------------------------------------------
    def host_shard_paths(self, paths: Sequence[str]) -> List[str]:
        """Deterministic round-robin assignment of input files to hosts."""
        return [p for i, p in enumerate(sorted(paths))
                if i % self.num_processes == self.process_id]

    def rows_per_host(self, n_global: int, ctx: Optional[MeshContext] = None) -> int:
        """Uniform per-host row-block size (ceil over hosts; one device per
        host, so no further rounding)."""
        return -(-n_global // self.num_processes)

    def host_row_slice(self, n_global: int, ctx: Optional[MeshContext] = None) -> slice:
        """This host's contiguous row block of a global ``(n_global, ...)``
        dataset; the tail host's slice may be short."""
        per = self.rows_per_host(n_global, ctx)
        lo = min(self.process_id * per, n_global)
        return slice(lo, min(lo + per, n_global))

    # -- global blocks -------------------------------------------------
    def global_row_sharded(self, host_local: np.ndarray, ctx: MeshContext,
                           n_global: Optional[int] = None) -> Tensor:
        """This rank's block of a row-sharded global array, on its device:
        ``host_local`` zero-padded up to ``rows_per_host(n_global)`` when
        ``n_global`` is given (padding rows must carry weight 0)."""
        if n_global is not None:
            short = self.rows_per_host(n_global, ctx) - host_local.shape[0]
            if short > 0:
                pad = np.zeros((short,) + host_local.shape[1:], host_local.dtype)
                host_local = np.concatenate([host_local, pad])
        return torch.from_numpy(np.ascontiguousarray(host_local)).to(ctx.device)

    def global_replicated(self, host_local: np.ndarray, ctx: MeshContext) -> Tensor:
        """Identical per-host data, held whole on every rank."""
        return torch.from_numpy(np.ascontiguousarray(host_local)).to(ctx.device)

    # -- coordination ----------------------------------------------------
    def barrier(self, name: str = "photon-ml-tpu-barrier",
                timeout: Optional[float] = None) -> None:
        """Block until every process reaches this point. Entry is the fault
        site ``multihost.barrier``, retried under the active I/O policy (the
        injected failure fires before the collective, so a retry is safe);
        ``timeout`` (default ``PHOTON_BARRIER_TIMEOUT``) raises
        :class:`BarrierTimeoutError` instead of hanging behind a wedged
        process, and is never retried."""
        from photon_ml_tpu_torch import resilience
        from photon_ml_tpu_torch.resilience import faults

        deadline = resolve_barrier_timeout(timeout)
        resilience.call_with_retry(
            lambda: faults.inject("multihost.barrier", name=name, process=self.process_id),
            resilience.current_config().io_policy, describe=f"barrier {name}")
        if self.num_processes > 1:
            ctx = self.mesh_context()
            sync = lambda: ctx.all_gather(torch.zeros(1, dtype=torch.int64))
            if deadline is None:
                sync()
            else:
                _call_with_deadline(sync, deadline,
                                    f"barrier {name!r} (process {self.process_id})")

    # -- health fencing --------------------------------------------------
    def agree_restore_step(self, local_step: Optional[int]) -> Optional[int]:
        """Collective MIN over every host's latest complete checkpoint step:
        the job resumes from the newest step every host can restore.
        ``None`` participates as -1; a -1 minimum means a fresh start."""
        if self.num_processes <= 1:
            return local_step
        mine = local_step if local_step is not None else -1
        gathered = np.concatenate([
            g.numpy() for g in self.mesh_context().all_gather(
                torch.tensor([mine], dtype=torch.int64))])
        agreed = int(gathered.min())
        if agreed != mine:
            logger.warning(
                "host %d: restoring step %s instead of local latest %s (collective-min "
                "agreement; per-host steps %s)", self.process_id,
                agreed if agreed >= 0 else None, local_step, gathered.tolist())
        return agreed if agreed >= 0 else None

    def write_heartbeat(self, directory: str, step: Optional[int] = None,
                        host_id: Optional[int] = None) -> str:
        """This host's heartbeat file (atomic, retried; fault site
        ``multihost.heartbeat``)."""
        return write_host_heartbeat(directory,
                                    self.process_id if host_id is None else host_id, step=step)

    def heartbeat_ages(self, directory: str) -> Dict[int, float]:
        return read_heartbeat_ages(directory)

    def describe_heartbeats(self, directory: str) -> str:
        """Coordinator-log line: every host's heartbeat age, and who never
        beat at all."""
        ages = self.heartbeat_ages(directory)
        parts = [f"host {pid}: {ages[pid]:.1f}s ago" if pid in ages
                 else f"host {pid}: NO HEARTBEAT" for pid in range(self.num_processes)]
        return "heartbeats: " + ", ".join(parts)

    def lost_hosts(self, directory: str, deadline: float,
                   missing_grace_elapsed: Optional[float] = None) -> List[int]:
        """The hosts whose heartbeat is older than ``deadline`` seconds."""
        return lost_hosts(self.heartbeat_ages(directory), range(self.num_processes), deadline,
                          missing_grace_elapsed)

    def coordinator_only_io(self) -> bool:
        """True when this process performs the global side effects (model
        save, metadata, logs of the whole job)."""
        return self.is_coordinator
