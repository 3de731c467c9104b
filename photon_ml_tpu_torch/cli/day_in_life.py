"""Day-in-the-life SLO harness on the card (port of tools/day_in_life.py):
one compressed day of production life under a single enforced error budget.

A diurnal request curve drawn from a few-million-user synthetic population
flows against a multi-replica serving fleet while a full day of operations
happens around it:

  * ``morning_ramp``   — steady traffic; served scores gated BITWISE
    against the single-store oracle AND the batch scoring driver.
  * ``midday_peak``    — peak traffic under seeded chaos at the registered
    fault sites (``serve.route``, ``serve.replica_scatter``) plus a fleet
    swap aborted at ``serve.fleet_swap_barrier``.
  * ``retrain_window`` — a REAL delta retrain (``--warm-start-from``) runs
    under live traffic (with ``PHOTON_SPARSE_KERNEL=pallas`` its block
    solves launch the GEVM kernel), its export rolls fleet-wide through the
    provenance gate (``FleetSwapper.rollout_delta``) after one
    chaos-aborted attempt; the generation flip is timestamped so every N-1
    answer after the barrier is counted against the staleness budget.
  * ``elastic_event``  — an owner replica (a ``cli.fleet_driver`` process
    over TCP) is ``kill -9``'d under traffic (heartbeat detection,
    degraded-but-attributed serving) and the training fleet shrinks and
    scales back up through ``EntityShardPlan.replan`` with chaos on
    ``multihost.membership`` and ``io.block_transfer`` absorbed by the
    retry machinery.
  * ``dtype_migration``— a replica-by-replica f32→bf16 roll is REFUSED
    (mixed-dtype fleet), the fleet-wide atomic bf16 roll lands (its new
    batch shapes attributed), and a same-dtype re-roll is gated free of
    new shapes.
  * ``night_drain``    — the curve tails off; the ledger finalizes.

Everything lands in one :class:`photon_ml_tpu_torch.slo.SLOLedger`:
per-phase p50/p99, error-budget spend, staleness, degradation attribution
(FleetStats counters are delta-attributed per phase, and a kind the
phase's SLO does not declare is a violation at count 1) and bytes moved.
``run_day`` writes the ledger sidecar (``slo-ledger.json``, which
``tools/fleetctl.py`` reads) and then enforces it: any phase over its
declared SLO fails the run.

The day, its phases, its SLOs (``build_spec``) and its traffic are the JAX
harness's. The fleet, the oracles and the retrain run on the card unless
``DayConfig.device`` (``--device cpu``) asks for the CPU::

    python -m photon_ml_tpu_torch.cli.day_in_life --out-dir /tmp/day

Downsizing knobs: ``--phase-seconds``, ``--peak-qps``, ``--population``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import select
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.slo import PhaseSLO, SLOLedger, SLOSpec

# the repository root: the replica processes run ``-m`` from it
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SECTIONS = {"global": ["fixedFeatures"], "per_user": ["userFeatures"]}
SECTIONS_FLAG = "global:fixedFeatures|per_user:userFeatures"

#: phase -> fraction of ``peak_qps`` (the diurnal curve)
DIURNAL_CURVE = {
    "morning_ramp": 0.4,
    "midday_peak": 1.0,
    "retrain_window": 0.7,
    "elastic_event": 0.5,
    "dtype_migration": 0.6,
    "night_drain": 0.2,
}


class DayInLifeError(AssertionError):
    """A lifecycle gate the ledger cannot express failed (harness-level
    invariant, e.g. a provenance refusal that did not refuse)."""


@dataclasses.dataclass
class DayConfig:
    """One day-in-the-life run, downsizable to a smoke."""

    out_dir: str
    #: synthetic user universe the cold tail of the curve draws from
    user_population: int = 3_000_000
    #: cold-request templates (each draw substitutes a fresh population id)
    cold_pool: int = 24
    num_replicas: int = 2
    traffic_threads: int = 3
    #: steady-traffic seconds per phase segment (the main duration knob)
    phase_seconds: float = 3.0
    peak_qps: float = 120.0
    seed: int = 20
    #: True: real --warm-start-from delta retrain; False: two synthetic
    #: model generations + fabricated committed manifests (fast smoke)
    real_retrain: bool = True
    #: True: subprocess TCP replicas + SIGKILL arm in elastic_event
    kill_arm: bool = True
    dtype_migration: bool = True
    #: True: gate morning scores against the real batch scoring driver
    batch_oracle: bool = True
    #: per-phase exact-quantile regime bound (past it: P2 streaming)
    exact_limit: int = 8192
    request_timeout_s: float = 60.0
    hedge_ms: Optional[float] = 250.0
    #: multiply every declared latency bound (slower machines)
    slo_scale: float = 1.0
    keep_work_dir: bool = False
    #: where the fleet, the oracles and the retrain run: "cuda" or "cpu"
    #: (the port's one field beyond the JAX harness's)
    device: str = "cuda"


def build_spec(cfg: DayConfig) -> SLOSpec:
    """The declared per-phase SLOs this run is gated on."""
    s = cfg.slo_scale
    common = ("hedged_fallback", "rerouted_fixed")
    return SLOSpec([
        PhaseSLO(
            "morning_ramp", p50_ms=400 * s, p99_ms=4000 * s,
            allowed_degradations=common,
        ),
        PhaseSLO(
            "midday_peak", p50_ms=600 * s, p99_ms=6000 * s,
            error_budget=0.05, chaos_window=True,
            allowed_degradations=common + (
                "chaos_absorbed_retry", "cold_entity_zero",
                "swap_abort_chaos", "stale_rescore",
            ),
        ),
        PhaseSLO(
            "retrain_window", p50_ms=3000 * s, p99_ms=20000 * s,
            error_budget=0.01, staleness_budget=50,
            allowed_degradations=common + (
                "stale_rescore", "rollout_abort_chaos",
                "chaos_absorbed_retry",
            ),
        ),
        PhaseSLO(
            "elastic_event", p50_ms=1500 * s, p99_ms=15000 * s,
            error_budget=0.05, chaos_window=True,
            allowed_degradations=common + (
                "cold_entity_zero", "dead_replica_skip", "replica_killed",
                "chaos_absorbed_retry", "cold_block_rebuild",
            ),
        ),
        PhaseSLO(
            "dtype_migration", p50_ms=3000 * s, p99_ms=30000 * s,
            error_budget=0.01, staleness_budget=100,
            allowed_degradations=common + (
                "mixed_dtype_refusal", "migration_compiles",
                "stale_rescore",
            ),
        ),
        PhaseSLO(
            "night_drain", p50_ms=400 * s, p99_ms=4000 * s,
            allowed_degradations=common,
        ),
    ])


# ---------------------------------------------------------------------------
# traffic engine: paced threads, bitwise classification, ledger recording
# ---------------------------------------------------------------------------


class _Traffic:
    """Paced request threads against one router.

    ``oracles`` is an ordered list of dicts:
      ``{"name", "scores", "role": "current"|"previous", "cold": arr|None}``
    Every answer is classified bitwise: current-generation match is
    healthy; previous-generation match AFTER the flip instant is a
    counted stale answer; a match of the generation's COLD variant
    (random effects zeroed — a dead/faulted owner's degraded answer) is
    healthy-but-attributed (the FleetStats degraded_rows delta carries
    the attribution); anything else is mixed-generation/divergent.
    """

    def __init__(self, ledger: SLOLedger, cfg: DayConfig, pool: List[dict],
                 warm_len: int):
        self.ledger = ledger
        self.cfg = cfg
        self.pool = pool
        self.warm_len = warm_len
        self.lock = threading.Lock()
        self.cold_ids_seen: set = set()

    def run(self, router, qps: float, seconds: float, oracles: List[dict],
            flip: Optional[dict] = None,
            counts: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        handle = self.start(router, qps, oracles, flip, counts)
        time.sleep(seconds)
        return handle.stop()

    def start(self, router, qps: float, oracles: List[dict],
              flip: Optional[dict] = None,
              counts: Optional[Dict[str, int]] = None):
        counts = counts if counts is not None else {}
        stop = threading.Event()
        threads = self.cfg.traffic_threads
        interval = threads / max(qps, 1e-6)
        pool, warm_len = self.pool, self.warm_len

        def worker(tid: int):
            rng = np.random.default_rng(self.cfg.seed * 1000 + tid)
            i = tid
            nxt = time.monotonic() + rng.random() * interval
            while not stop.is_set():
                k = i % len(pool)
                i += threads
                req = pool[k]
                if k >= warm_len:
                    # cold tail: a fresh id from the million-user
                    # population (unknown to the store -> same bitwise
                    # cold answer as the template oracle)
                    uid = int(rng.integers(0, self.cfg.user_population))
                    req = dict(req, ids={"userId": f"z{uid}"})
                    with self.lock:
                        self.cold_ids_seen.add(uid)
                t0 = time.monotonic()
                try:
                    got = router.submit_rows([req]).result(
                        self.cfg.request_timeout_s
                    )
                except Exception:  # noqa: BLE001 — every failure is budget spend, asserted by the SLO gate
                    self.ledger.record_error()
                    self._bump(counts, "errors")
                else:
                    done = time.monotonic()
                    self.ledger.record_request(done - t0, len(got))
                    self._classify(got, k, done, oracles, flip, counts)
                nxt += interval
                delay = nxt - time.monotonic()
                if delay > 0:
                    stop.wait(min(delay, 1.0))
                else:
                    nxt = time.monotonic()  # fell behind: re-anchor

        ths = [
            threading.Thread(target=worker, args=(t,), daemon=True)
            for t in range(threads)
        ]
        for t in ths:
            t.start()

        outer = self

        class _Handle:
            def stop(self) -> Dict[str, int]:
                stop.set()
                for t in ths:
                    t.join(timeout=outer.cfg.request_timeout_s + 30)
                return counts

        return _Handle()

    def _bump(self, counts: Dict[str, int], key: str, n: int = 1) -> None:
        with self.lock:
            counts[key] = counts.get(key, 0) + n

    def _classify(self, got, k: int, done: float, oracles: List[dict],
                  flip: Optional[dict], counts: Dict[str, int]) -> None:
        if len(got) != 1:
            self.ledger.record_divergence()
            self._bump(counts, "unmatched")
            return
        for o in oracles:
            if got[0] == o["scores"][k]:
                if (
                    o["role"] == "previous"
                    and flip is not None
                    and flip.get("t") is not None
                    and done > flip["t"]
                ):
                    self.ledger.record_stale_answer()
                    self._bump(counts, "stale")
                else:
                    self._bump(counts, o["name"])
                return
        for o in oracles:
            cold = o.get("cold")
            if cold is not None and got[0] == cold[k]:
                # degraded answer (dead/faulted owner's random effects
                # served as the cold-entity 0) — bitwise-expected, and
                # attributed via the FleetStats degraded_rows delta
                self._bump(counts, "degraded")
                return
        if len(oracles) > 1:
            self.ledger.record_mixed_generation()
        else:
            self.ledger.record_divergence()
        self._bump(counts, "unmatched")


# ---------------------------------------------------------------------------
# the day
# ---------------------------------------------------------------------------


def run_day(cfg: DayConfig, enforce: bool = True) -> dict:
    """Run the whole day; write the ledger sidecar under ``cfg.out_dir``;
    enforce the SLO gate. Returns ``{"ledger", "ledger_path", "extra"}``."""
    from photon_ml_tpu_torch.compile import ShapeBucketer
    from photon_ml_tpu_torch.resilience import FaultPlan, FaultSpec, fault_scope
    from photon_ml_tpu_torch.retrain.manifest import RetrainManifest
    from photon_ml_tpu_torch.serve import (
        FleetStats,
        ModelStore,
        ScoringServer,
        ServeStats,
        build_model_store,
    )
    from photon_ml_tpu_torch.serve.fleet import (
        FleetRouter,
        FleetSwapError,
        FleetSwapper,
        LocalReplicaClient,
        ReplicaEngine,
        build_fleet_stores,
        load_fleet_meta,
        replica_store_dir,
    )

    os.makedirs(cfg.out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="day-in-life-")
    spec = build_spec(cfg)
    ledger = SLOLedger(spec, exact_limit=cfg.exact_limit)
    extra: dict = {"config": dataclasses.asdict(cfg)}
    rng = np.random.default_rng(cfg.seed)

    def single_oracle(model_dir: str, reqs: List[dict],
                      store_dtype: str = "f32") -> Tuple[np.ndarray, np.ndarray]:
        """(exact scores, cold-variant scores) for ``reqs`` against ONE
        store built from ``model_dir`` — the bitwise reference."""
        sdir = tempfile.mkdtemp(dir=tmp, prefix=f"oracle-{store_dtype}-")
        build_model_store(
            model_dir, sdir, bucketer=ShapeBucketer(), store_dtype=store_dtype
        )
        server = ScoringServer(
            ModelStore(sdir), shard_sections=SECTIONS, max_batch_rows=32,
            max_wait_ms=2.0, stats=ServeStats(), device=cfg.device,
        )
        server.warmup(warm_nnz=16)
        scores = server.score_rows(reqs)
        stripped = [dict(q, ids={}) for q in reqs]
        cold = server.score_rows(stripped)
        server.close()
        return scores, cold

    try:
        # ------------------------------------------------------------------
        # setup: generation-0 model (+ the day's retrain inputs), the
        # request pool, the serving fleet
        # ------------------------------------------------------------------
        if cfg.real_retrain:
            setup = _setup_real_models(cfg, tmp, rng)
        else:
            setup = _setup_synthetic_models(cfg, tmp, rng)
        model_g0 = setup["model_g0"]
        warm_reqs = setup["warm_reqs"]

        pool = list(warm_reqs)
        warm_len = len(pool)
        for j in range(cfg.cold_pool):
            pool.append(dict(pool[j % warm_len], ids={"userId": f"z-cold-{j}"}))

        oracle_g0, cold_g0 = single_oracle(model_g0, pool)
        if len(oracle_g0) != len(pool):
            raise DayInLifeError(
                f"oracle width {len(oracle_g0)} != pool {len(pool)} "
                "(requests must be single-row)"
            )
        g0 = {"name": "g0", "scores": oracle_g0, "cold": cold_g0,
              "role": "current"}

        fleet_g0 = os.path.join(tmp, "fleet-g0")
        build_fleet_stores(
            model_g0, fleet_g0, num_replicas=cfg.num_replicas,
            bucketer=ShapeBucketer(),
        )

        engines = []
        for r in range(cfg.num_replicas):
            e = ReplicaEngine(
                ModelStore(replica_store_dir(fleet_g0, r)), replica_id=r,
                num_replicas=cfg.num_replicas, shard_sections=SECTIONS,
                max_batch_rows=32, max_wait_ms=2.0, stats=ServeStats(),
                device=cfg.device,
            )
            e.warmup(warm_nnz=16)
            engines.append(e)
        router = FleetRouter(
            load_fleet_meta(fleet_g0),
            [LocalReplicaClient(e) for e in engines],
            hedge_ms=cfg.hedge_ms,
            request_timeout_s=cfg.request_timeout_s,
            stats=FleetStats(),
        )
        swapper = FleetSwapper(router)
        traffic = _Traffic(ledger, cfg, pool, warm_len)
        qps = lambda name: cfg.peak_qps * DIURNAL_CURVE[name]  # noqa: E731

        # warm the fleet path (compiles + connections) outside any phase
        for q in pool[: min(8, len(pool))]:
            router.score_rows([q])

        flip: dict = {"t": None}
        orig_flip = router.flip_generation

        def flip_hook(epoch: int) -> None:
            orig_flip(epoch)
            flip["t"] = time.monotonic()
            ledger.mark_flip(epoch)

        # ------------------------------------------------------------------
        # morning_ramp: steady traffic, bitwise vs oracle AND batch driver
        # ------------------------------------------------------------------
        ledger.begin_phase("morning_ramp", stats=router.stats)
        c = traffic.run(router, qps("morning_ramp"), cfg.phase_seconds, [g0])
        if cfg.batch_oracle:
            drv_scores = _batch_driver_scores(cfg, tmp, setup)
            same = bool(np.array_equal(drv_scores, oracle_g0[:warm_len]))
            extra["morning_batch_driver_bitwise"] = same
            if not same:
                ledger.record_divergence(
                    int(np.sum(drv_scores != oracle_g0[:warm_len])) or 1
                )
        extra["morning_traffic"] = dict(c)
        ledger.end_phase()

        # ------------------------------------------------------------------
        # midday_peak: chaos at the registered serve sites + aborted swap
        # ------------------------------------------------------------------
        fleet_g0b = os.path.join(tmp, "fleet-g0b")
        build_fleet_stores(
            model_g0, fleet_g0b, num_replicas=cfg.num_replicas,
            bucketer=ShapeBucketer(),
        )
        ledger.begin_phase("midday_peak", stats=router.stats)
        chaos = FaultPlan([
            FaultSpec("serve.route", rate=0.02, times=6, seed=cfg.seed),
            FaultSpec("serve.replica_scatter", rate=0.03, times=8,
                      seed=cfg.seed + 1),
            FaultSpec("serve.fleet_swap_barrier", at=1),
        ])
        with fault_scope(chaos):
            handle = traffic.start(router, qps("midday_peak"), [g0], flip)
            time.sleep(cfg.phase_seconds * 0.4)
            try:
                swapper.swap(fleet_g0b)
                raise DayInLifeError(
                    "barrier-chaos swap landed — the injected barrier "
                    "fault must abort it"
                )
            except FleetSwapError:
                ledger.attribute(
                    "swap_abort_chaos",
                    detail="swap aborted at serve.fleet_swap_barrier (at=1)",
                )
            time.sleep(cfg.phase_seconds * 0.6)
            c = handle.stop()
        if router.generation != 0:
            raise DayInLifeError(
                f"aborted swap moved the generation to {router.generation}"
            )
        extra["midday_traffic"] = dict(c)
        extra["midday_chaos_fires"] = {
            site: chaos.fire_count(site)
            for site in ("serve.route", "serve.replica_scatter",
                         "serve.fleet_swap_barrier")
        }
        ledger.end_phase()

        # ------------------------------------------------------------------
        # retrain_window: delta retrain under traffic -> provenance-gated
        # fleet-wide rollout (one chaos-aborted attempt first)
        # ------------------------------------------------------------------
        ledger.begin_phase("retrain_window", stats=router.stats)
        handle = traffic.start(router, qps("retrain_window"), [g0], flip)
        retrain_dir, model_g1, t_retrain = setup["retrain"]()
        fleet_g1 = os.path.join(tmp, "fleet-g1")
        build_fleet_stores(
            model_g1, fleet_g1, num_replicas=cfg.num_replicas,
            bucketer=ShapeBucketer(),
        )
        handle.stop()
        extra["retrain_seconds"] = round(t_retrain, 2)

        # provenance refusal: an export from the WRONG model must abort
        wrong = os.path.join(tmp, "retrain-wrong")
        os.makedirs(wrong, exist_ok=True)
        RetrainManifest(
            output_dir=wrong, model_dir=model_g0,
            task="LOGISTIC_REGRESSION", file_stats=[], ingest_inputs={},
            ingest_digest="day", updating_sequence=[], coordinates={},
        ).save(wrong)
        try:
            swapper.rollout_delta(fleet_g1, wrong)
            raise DayInLifeError("mismatched-provenance rollout landed")
        except FleetSwapError as e:
            if "mismatched" not in str(e):
                raise
        extra["retrain_provenance_refused"] = True

        oracle_g1, cold_g1 = single_oracle(model_g1, pool)
        g1 = {"name": "g1", "scores": oracle_g1, "cold": cold_g1,
              "role": "current"}
        g0_prev = dict(g0, role="previous")

        router.flip_generation = flip_hook
        try:
            handle = traffic.start(
                router, qps("retrain_window"), [g1, g0_prev], flip
            )
            rollout_chaos = FaultPlan(
                [FaultSpec("serve.fleet_delta_rollout", at=1)]
            )
            with fault_scope(rollout_chaos):
                try:
                    swapper.rollout_delta(fleet_g1, retrain_dir)
                    raise DayInLifeError(
                        "rollout-entry chaos did not abort the rollout"
                    )
                except FleetSwapError:
                    ledger.attribute(
                        "rollout_abort_chaos",
                        detail="rollout aborted at serve.fleet_delta_rollout",
                    )
            report = swapper.rollout_delta(fleet_g1, retrain_dir)
            if report["dropped_requests"]:
                ledger.record_drop(int(report["dropped_requests"]))
            if report["new_compiles"]:
                # same slab geometry -> the roll must be compile-free;
                # attributing it here FAILS the phase (not declared)
                ledger.attribute(
                    "migration_compiles", n=int(report["new_compiles"]),
                    detail="delta rollout was not compile-free",
                )
            time.sleep(cfg.phase_seconds * 0.5)
            c = handle.stop()
        finally:
            del router.flip_generation  # restore the class method
        extra["retrain_traffic"] = dict(c)
        extra["retrain_rollout_generation"] = int(report["generation"])
        extra["retrain_rollout_new_compiles"] = int(report["new_compiles"])
        if c.get("g1", 0) == 0:
            raise DayInLifeError("no traffic observed at generation 1")
        post = np.concatenate([router.score_rows([q]) for q in pool])
        if not np.array_equal(post, oracle_g1):
            ledger.record_divergence(int(np.sum(post != oracle_g1)))
        ledger.end_phase()
        flip["t"] = None

        # ------------------------------------------------------------------
        # elastic_event: kill -9 an owner under traffic + shrink/scale-up
        # through EntityShardPlan.replan with absorbed chaos
        # ------------------------------------------------------------------
        if cfg.kill_arm:
            _elastic_kill_arm(
                cfg, tmp, ledger, traffic, fleet_g1, g1, extra, qps
            )
        else:
            ledger.begin_phase("elastic_event", stats=router.stats)
            c = traffic.run(
                router, qps("elastic_event"), cfg.phase_seconds, [g1]
            )
            extra["elastic_traffic"] = dict(c)
        _elastic_replan_arm(cfg, tmp, ledger, extra)
        ledger.end_phase()

        # ------------------------------------------------------------------
        # dtype_migration: refused mixed roll, atomic bf16 roll (compiles
        # attributed), clean same-dtype re-roll gated compile-free
        # ------------------------------------------------------------------
        if cfg.dtype_migration:
            fleet_bf16 = os.path.join(tmp, "fleet-g1-bf16")
            build_fleet_stores(
                model_g1, fleet_bf16, num_replicas=cfg.num_replicas,
                bucketer=ShapeBucketer(), store_dtype="bf16",
            )
            oracle_b, cold_b = single_oracle(model_g1, pool, "bf16")
            gb = {"name": "g1_bf16", "scores": oracle_b, "cold": cold_b,
                  "role": "current"}
            g1_prev = dict(g1, role="previous")

            ledger.begin_phase("dtype_migration", stats=router.stats)
            # replica-by-replica roll: replica 0's store dir swapped to
            # bf16 while replica 1 stays f32 — the fleet meta loader must
            # REFUSE the mixed fleet before anything serves from it
            mixed = os.path.join(tmp, "fleet-mixed")
            shutil.copytree(fleet_g1, mixed)
            shutil.rmtree(replica_store_dir(mixed, 0))
            shutil.copytree(
                replica_store_dir(fleet_bf16, 0), replica_store_dir(mixed, 0)
            )
            # fleet.json records absolute replica store paths: re-point
            # them into the copy so the loader sees the half-rolled fleet
            mpath = os.path.join(mixed, "fleet.json")
            with open(mpath) as f:
                mmeta = json.load(f)
            for rep in mmeta["replicas"]:
                rep["store_dir"] = replica_store_dir(
                    mixed, int(rep["replica"])
                )
            with open(mpath, "w") as f:
                json.dump(mmeta, f)
            try:
                load_fleet_meta(mixed)
                raise DayInLifeError("mixed-dtype fleet meta loaded")
            except IOError as e:
                if "MIXED-DTYPE" not in str(e):
                    raise
                ledger.attribute(
                    "mixed_dtype_refusal",
                    detail="replica-by-replica f32->bf16 roll refused",
                )
            extra["migration_mixed_refused"] = True

            router.flip_generation = flip_hook
            try:
                handle = traffic.start(
                    router, qps("dtype_migration"), [gb, g1_prev], flip
                )
                rep1 = swapper.swap(fleet_bf16)
                if rep1["dropped_requests"]:
                    ledger.record_drop(int(rep1["dropped_requests"]))
                if rep1["new_compiles"]:
                    ledger.attribute(
                        "migration_compiles", n=int(rep1["new_compiles"]),
                        detail="fleet-wide f32->bf16 roll",
                    )
                time.sleep(cfg.phase_seconds * 0.5)
                # clean same-dtype roll: a second bf16 export of the SAME
                # model must land compile-free
                fleet_bf16b = os.path.join(tmp, "fleet-g1-bf16b")
                build_fleet_stores(
                    model_g1, fleet_bf16b, num_replicas=cfg.num_replicas,
                    bucketer=ShapeBucketer(), store_dtype="bf16",
                )
                rep2 = swapper.swap(fleet_bf16b)
                if rep2["dropped_requests"]:
                    ledger.record_drop(int(rep2["dropped_requests"]))
                time.sleep(cfg.phase_seconds * 0.3)
                c = handle.stop()
            finally:
                del router.flip_generation
            extra["migration_traffic"] = dict(c)
            extra["migration_bf16_new_compiles"] = int(rep1["new_compiles"])
            extra["migration_same_dtype_new_compiles"] = int(
                rep2["new_compiles"]
            )
            if rep2["new_compiles"]:
                raise DayInLifeError(
                    f"same-dtype re-roll compiled {rep2['new_compiles']} "
                    "executables — must be compile-free"
                )
            post = np.concatenate([router.score_rows([q]) for q in pool])
            if not np.array_equal(post, oracle_b):
                ledger.record_divergence(int(np.sum(post != oracle_b)))
            ledger.end_phase()
            flip["t"] = None
            night_oracle = gb
        else:
            night_oracle = g1

        # ------------------------------------------------------------------
        # night_drain
        # ------------------------------------------------------------------
        ledger.begin_phase("night_drain", stats=router.stats)
        c = traffic.run(
            router, qps("night_drain"), cfg.phase_seconds, [night_oracle]
        )
        extra["night_traffic"] = dict(c)
        ledger.end_phase()

        router.close()
        for e in engines:
            e.close()

        extra["population"] = {
            "universe": cfg.user_population,
            "warm_users": setup["num_users"],
            "distinct_cold_users_drawn": len(traffic.cold_ids_seen),
        }
        payload = ledger.finalize()
        path = ledger.write(cfg.out_dir, payload)
        if enforce:
            ledger.enforce()
        return {"ledger": payload, "ledger_path": path, "extra": extra}
    finally:
        if not cfg.keep_work_dir:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# setup arms
# ---------------------------------------------------------------------------


def _setup_synthetic_models(cfg: DayConfig, tmp: str, rng) -> dict:
    """Fast smoke: two saved synthetic generations + fabricated committed
    retrain manifests (the delta_rollout bench pattern)."""
    from photon_ml_tpu_torch.retrain.manifest import RetrainManifest

    num_users = 96
    d_fixed, d_random = 8, 6
    data, truth = _glmix_data(
        rng, num_users=num_users, rows_per_user_range=(4, 8),
        d_fixed=d_fixed, d_random=d_random,
    )
    offsets = rng.normal(size=data.num_rows).astype(np.float32)
    models = []
    for g in range(2):
        mdir = os.path.join(tmp, f"model-g{g}")
        _save_synthetic_game_model(
            mdir, np.random.default_rng(cfg.seed + 100 + g),
            d_fixed=d_fixed, d_random=d_random, num_users=num_users,
        )
        models.append(mdir)
    sample = list(range(min(64, data.num_rows)))
    records = list(_game_avro_records(data, sample, truth, offsets))
    in_dir = os.path.join(tmp, "pool-in")
    os.makedirs(in_dir)
    _write_game_avro(
        os.path.join(in_dir, "part-0.avro"), data, sample, truth, offsets
    )

    def retrain():
        rd = os.path.join(tmp, "retrain-g1")
        os.makedirs(rd, exist_ok=True)
        RetrainManifest(
            output_dir=rd, model_dir=models[1],
            task="LOGISTIC_REGRESSION", file_stats=[], ingest_inputs={},
            ingest_digest="day", updating_sequence=[], coordinates={},
        ).save(rd)
        return rd, models[1], 0.0

    return {
        "model_g0": models[0],
        "warm_reqs": _serve_requests(records),
        "in_dir": in_dir,
        "num_users": num_users,
        "retrain": retrain,
    }


def _setup_real_models(cfg: DayConfig, tmp: str, rng) -> dict:
    """The real daily loop: train day-0, and return a ``retrain`` thunk
    that mutates one input file and delta-retrains with
    ``--warm-start-from`` (the retrain_delta bench geometry, downsized:
    uniform per-user counts so the count-sorted blocking stays
    file-aligned and the re-memory budget cuts blocks of 12 users)."""
    from photon_ml_tpu_torch.cli import game_training_driver
    from photon_ml_tpu_torch.retrain.manifest import RetrainManifest

    num_files, users_per_file = 2, 60
    num_users = num_files * users_per_file
    d_fixed, d_random = 8, 6
    rows_per_user = np.full(num_users, 24)
    n = int(rows_per_user.sum())
    user_of_row = np.repeat(np.arange(num_users, dtype=np.int32), rows_per_user)
    x_fixed = rng.normal(size=(n, d_fixed)).astype(np.float32)
    x_random = rng.normal(size=(n, d_random)).astype(np.float32)
    w_fixed = rng.normal(size=d_fixed).astype(np.float32)
    w_users = (rng.normal(size=(num_users, d_random)) * 1.2).astype(np.float32)
    margin = x_fixed @ w_fixed + np.sum(x_random * w_users[user_of_row], axis=1)
    y = (1.0 / (1.0 + np.exp(-margin)) > rng.random(n)).astype(np.float32)
    gd = _Data(response=y, user_of_row=user_of_row,
               vocab=[f"u{i:05d}" for i in range(num_users)])
    truth = {"x_fixed": x_fixed, "x_random": x_random}
    user_start = np.concatenate([[0], np.cumsum(rows_per_user)[:-1]])
    pos_in_user = np.arange(n) - user_start[user_of_row]
    val_mask = pos_in_user >= rows_per_user[user_of_row] - 4
    train_dir = os.path.join(tmp, "train")
    val_dir = os.path.join(tmp, "validate")
    os.makedirs(train_dir)
    os.makedirs(val_dir)
    file_rows = []
    for k in range(num_files):
        in_file = (
            (user_of_row >= users_per_file * k)
            & (user_of_row < users_per_file * (k + 1))
            & ~val_mask
        )
        rows = np.nonzero(in_file)[0]
        file_rows.append(rows)
        _write_game_avro(
            os.path.join(train_dir, f"part-{k}.avro"), gd, rows, truth
        )
    _write_game_avro(
        os.path.join(val_dir, "part-0.avro"), gd, np.nonzero(val_mask)[0],
        truth,
    )

    def run(out, warm_from=None):
        args = [
            "--train-input-dirs", train_dir,
            "--validate-input-dirs", val_dir,
            "--output-dir", out,
            "--task-type", "LOGISTIC_REGRESSION",
            "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
            "--updating-sequence", "fixed,per-user",
            "--fixed-effect-data-configurations", "fixed:global,1",
            "--random-effect-data-configurations",
            "per-user:userId,per_user,1,-1,-1,-1,INDEX_MAP",
            "--fixed-effect-optimization-configurations",
            "fixed:100,1e-10,0.01,1,LBFGS,L2",
            "--random-effect-optimization-configurations",
            "per-user:100,1e-10,0.1,1,LBFGS,L2",
            "--evaluator-type", "AUC",
            "--delete-output-dir-if-exists", "true",
            "--re-memory-budget-mb", "0.0068",
            "--num-iterations", "6",
            "--tensor-cache", os.path.join(tmp, "tcache"),
            "--device", cfg.device,
        ]
        if warm_from:
            args += ["--warm-start-from", warm_from]
        t0 = time.perf_counter()
        game_training_driver.main(args)
        return time.perf_counter() - t0

    day0_out = os.path.join(tmp, "day0")
    run(day0_out)
    rman0 = RetrainManifest.load(day0_out)

    sample = np.nonzero(val_mask)[0][:64]
    pool_offsets = rng.normal(size=n).astype(np.float32)  # indexed by row id
    records = list(_game_avro_records(gd, sample, truth, pool_offsets))
    in_dir = os.path.join(tmp, "pool-in")
    os.makedirs(in_dir)
    _write_game_avro(
        os.path.join(in_dir, "part-0.avro"), gd, sample, truth, pool_offsets
    )

    def retrain():
        # day rollover: file 1's labels move (same rows, same users — the
        # store slab shapes stay swap-compatible), then the delta retrain
        # warm-starts from day-0
        mrng = np.random.default_rng(cfg.seed + 41)
        y2 = np.array(gd.response)
        rows = file_rows[num_files - 1]
        flip_rows = rows[mrng.random(len(rows)) < 0.2]
        y2[flip_rows] = 1.0 - y2[flip_rows]
        time.sleep(0.02)  # mtime_ns must move on coarse filesystems
        _write_game_avro(
            os.path.join(train_dir, f"part-{num_files - 1}.avro"),
            dataclasses.replace(gd, response=y2), rows, truth,
        )
        delta_out = os.path.join(tmp, "day1-delta")
        t = run(delta_out, warm_from=day0_out)
        rman1 = RetrainManifest.load(delta_out)
        return delta_out, rman1.model_dir, t

    return {
        "model_g0": rman0.model_dir,
        "warm_reqs": _serve_requests(records),
        "in_dir": in_dir,
        "num_users": num_users,
        "retrain": retrain,
    }


def _batch_driver_scores(cfg: DayConfig, tmp: str, setup: dict) -> np.ndarray:
    """The batch scoring driver over the pool's Avro — the second bitwise
    oracle the served morning scores must match."""
    from photon_ml_tpu_torch.cli import game_scoring_driver
    from photon_ml_tpu_torch.compile import ShapeBucketer
    from photon_ml_tpu_torch.serve import build_model_store

    sdir = os.path.join(tmp, "batch-oracle-store")
    build_model_store(setup["model_g0"], sdir, bucketer=ShapeBucketer())
    drv = game_scoring_driver.main([
        "--input-dirs", setup["in_dir"],
        "--game-model-input-dir", setup["model_g0"],
        "--output-dir", os.path.join(tmp, "batch-oracle-out"),
        "--offheap-indexmap-dir", os.path.join(sdir, "features"),
        "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
        "--delete-output-dir-if-exists", "true",
        "--device", cfg.device,
    ])
    return np.asarray(drv.scores, np.float32)


# ---------------------------------------------------------------------------
# elastic_event arms
# ---------------------------------------------------------------------------


def _elastic_kill_arm(cfg: DayConfig, tmp: str, ledger: SLOLedger,
                      traffic: _Traffic, fleet_dir: str, oracle: dict,
                      extra: dict, qps) -> None:
    """Subprocess TCP replicas; SIGKILL one owner under live traffic;
    heartbeat detection; degraded-but-attributed serving. Opens the
    elastic_event phase (baselined on the TCP router's FleetStats)."""
    from photon_ml_tpu_torch.serve import FleetStats
    from photon_ml_tpu_torch.serve.fleet import (
        FleetRouter,
        TcpReplicaClient,
        load_fleet_meta,
    )

    hb_dir = os.path.join(tmp, "hb-elastic")
    procs, addrs = [], []
    try:
        # every replica process starts at once; each is then waited for
        procs.extend(_spawn_replica(cfg, tmp, fleet_dir, r, hb_dir)
                     for r in range(cfg.num_replicas))
        addrs.extend(_await_ready(p, r, tmp) for r, p in enumerate(procs))
        router = FleetRouter(
            load_fleet_meta(fleet_dir),
            [TcpReplicaClient(a) for a in addrs],
            heartbeat_dir=hb_dir, heartbeat_deadline_s=3.0,
            request_timeout_s=cfg.request_timeout_s, stats=FleetStats(),
        )
        for q in traffic.pool[:4]:
            router.score_rows([q])  # warm connections

        ledger.begin_phase("elastic_event", stats=router.stats)
        handle = traffic.start(router, qps("elastic_event"), [oracle])
        time.sleep(cfg.phase_seconds * 0.3)
        procs[1].kill()  # SIGKILL — the heartbeat goes stale, not clean
        ledger.attribute(
            "replica_killed",
            detail=f"replica 1 (pid {procs[1].pid}) SIGKILL'd",
        )
        t0 = time.monotonic()
        while 1 in router.live_replicas():
            if time.monotonic() - t0 > 20.0:
                handle.stop()
                raise DayInLifeError(
                    "router failed to mark the killed replica dead within "
                    "the heartbeat deadline"
                )
            time.sleep(0.2)
        extra["elastic_heartbeat_detect_s"] = round(time.monotonic() - t0, 2)
        time.sleep(cfg.phase_seconds * 0.7)
        c = handle.stop()
        extra["elastic_traffic"] = dict(c)
        router.close()
    finally:
        _reap_replicas(procs, addrs)


def _spawn_replica(cfg: DayConfig, tmp: str, fleet_dir: str, r: int, hb_dir: str):
    """Start replica ``r`` as a ``cli.fleet_driver`` process on the card
    (``cfg.device``); :func:`_await_ready` waits for its READY line."""
    log_path = os.path.join(tmp, f"replica-{r}.log")
    # stderr to a FILE, stdout a pipe only for the one READY line (the
    # perhost lesson: children must never block on a full parent pipe)
    with open(log_path, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.cli.fleet_driver",
             "--fleet-dir", fleet_dir, "--replica-id", str(r),
             "--num-fleet-replicas", str(cfg.num_replicas),
             "--heartbeat-dir", hb_dir,
             "--feature-shard-id-to-feature-section-keys-map", SECTIONS_FLAG,
             "--max-batch-rows", "32", "--warm-nnz", "16", "--device", cfg.device],
            stdout=subprocess.PIPE, stderr=lf, text=True,
            stdin=subprocess.DEVNULL, cwd=_ROOT,
        )
    return proc


def _await_ready(proc, r: int, tmp: str, timeout: float = 240.0) -> str:
    """The address replica ``r`` serves on, from its READY line."""
    log_path = os.path.join(tmp, f"replica-{r}.log")
    deadline = time.monotonic() + timeout
    line = ""
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            break
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready:
            line = proc.stdout.readline().strip()
            if line:
                break
    if not line.startswith("READY "):
        proc.kill()
        with open(log_path) as f:
            tail = f.read()[-1500:]
        raise DayInLifeError(
            f"fleet replica {r} failed to come up within {timeout}s "
            f"(got {line!r}):\n{tail}"
        )
    return line.split()[1]


def _reap_replicas(procs, addrs) -> None:
    import socket

    for addr in addrs:
        host, _, port = addr.rpartition(":")
        try:
            with socket.create_connection((host, int(port)), timeout=5) as s:
                s.sendall(b'{"cmd": "shutdown"}\n')
                s.recv(100)
        except OSError:
            pass
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _elastic_replan_arm(cfg: DayConfig, tmp: str, ledger: SLOLedger,
                        extra: dict) -> None:
    """Training-side elasticity inside the open elastic_event phase: a
    3-owner shard plan loses an owner (membership-invariant blocking,
    version+1 re-plan), moved blocks transfer as retried file copies
    (bytes counted), then a scale-up folds a new owner back in — with
    chaos on ``multihost.membership`` and ``io.block_transfer`` absorbed
    by the retry machinery and attributed."""
    from photon_ml_tpu_torch import resilience
    from photon_ml_tpu_torch.parallel.elastic import (
        FleetMembership,
        commit_membership,
        declare_lost_hosts,
        read_membership,
        request_scale_up,
    )
    from photon_ml_tpu_torch.parallel.perhost_streaming import EntityShardPlan
    from photon_ml_tpu_torch.resilience import (
        FaultPlan,
        FaultSpec,
        fault_scope,
        faults,
    )

    rng = np.random.default_rng(cfg.seed + 7)
    counts = rng.integers(8, 24, size=240)
    plan1 = EntityShardPlan.build(
        counts, 3, global_dim=7, block_entities=16, hosts=[0, 1, 2]
    )
    edir = os.path.join(tmp, "elastic-fleet")

    def block_path(phys: int, gid: int) -> str:
        return os.path.join(edir, f"host-{phys}", f"block-g{gid:05d}.npy")

    mem1 = FleetMembership.initial(3)
    phys1 = mem1.physical_owners(plan1.owners)
    for gid in range(len(plan1.owners)):
        path = block_path(int(phys1[gid]), gid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, rng.normal(size=(int(counts[gid % len(counts)]), 7)))

    def transfer(moved) -> int:
        moved_bytes = 0
        for gid, old_p, new_p in moved:
            src, dst = block_path(old_p, gid), block_path(new_p, gid)

            def copy_once(src=src, dst=dst, gid=gid):
                faults.inject(
                    "io.block_transfer", block=gid, what="block",
                    src=src, dst=dst,
                )
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                t = f"{dst}.tmp-{os.getpid()}"
                shutil.copyfile(src, t)
                os.replace(t, dst)

            resilience.call_with_retry(
                copy_once, resilience.current_config().io_policy,
                describe=f"day-in-life block {gid} transfer",
            )
            moved_bytes += os.path.getsize(dst)
        return moved_bytes

    chaos = FaultPlan([
        FaultSpec("multihost.membership", at=2),
        FaultSpec("io.block_transfer", at=1),
    ])
    with fault_scope(chaos):
        commit_membership(edir, mem1)
        # owner 2 is lost: operator declaration, shrink re-plan, block
        # transfers onto the survivors
        declare_lost_hosts(edir, [2], reason="day-in-life owner loss")
        mem2 = mem1.without([2])
        plan2 = plan1.replan(mem2.hosts)
        moved_down = plan1.moved_blocks(plan2, mem1, mem2)
        bytes_down = transfer(moved_down)
        commit_membership(edir, mem2)
        # scale back up: a new physical process adopts logical owner 3
        request_scale_up(edir, {3: 3}, reason="day-in-life scale-up")
        mem3 = mem2.with_added({3: 3})
        plan3 = plan2.replan(mem3.hosts)
        moved_up = plan2.moved_blocks(plan3, mem2, mem3)
        bytes_up = transfer(moved_up)
        commit_membership(edir, mem3)
        final = read_membership(edir)

    if final is None or final.version != mem3.version:
        raise DayInLifeError(
            f"elastic membership did not converge (got "
            f"{None if final is None else final.version}, "
            f"want {mem3.version})"
        )
    absorbed = chaos.fire_count("multihost.membership") + chaos.fire_count(
        "io.block_transfer"
    )
    if absorbed:
        ledger.attribute(
            "chaos_absorbed_retry", n=absorbed,
            detail=(
                f"{chaos.fire_count('multihost.membership')} membership + "
                f"{chaos.fire_count('io.block_transfer')} block-transfer "
                "faults absorbed by retries"
            ),
        )
    ledger.record_bytes_moved(bytes_down + bytes_up)
    extra["elastic_replan"] = {
        "blocks": len(plan1.owners),
        "moved_on_shrink": len(moved_down),
        "moved_on_scale_up": len(moved_up),
        "bytes_moved": bytes_down + bytes_up,
        "membership_versions": [mem1.version, mem2.version, mem3.version],
        "plan_versions": [plan1.version, plan2.version, plan3.version],
    }


# ---------------------------------------------------------------------------
# the day's synthetic data (the draws of the JAX harness's fixtures)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Data:
    """The part of a GLMix dataset the Avro records and requests read."""

    response: np.ndarray
    user_of_row: np.ndarray
    vocab: List[str]

    @property
    def num_rows(self) -> int:
        return len(self.response)


def _glmix_data(rng, num_users: int, rows_per_user_range: Tuple[int, int],
                d_fixed: int, d_random: int) -> Tuple[_Data, Dict[str, np.ndarray]]:
    """Logistic GLMix rows, y ~ Bernoulli(sigmoid(x_f.w_fixed + x_r.w_user)),
    drawn in the order of the JAX tests' ``make_glmix_data``."""
    rows_per_user = rng.integers(*rows_per_user_range, size=num_users)
    n = int(rows_per_user.sum())
    user_of_row = np.repeat(np.arange(num_users, dtype=np.int32), rows_per_user)
    user_of_row = user_of_row[rng.permutation(n)]
    x_fixed = rng.normal(size=(n, d_fixed)).astype(np.float32)
    x_random = rng.normal(size=(n, d_random)).astype(np.float32)
    w_fixed = (rng.normal(size=d_fixed) * 1.0).astype(np.float32)
    w_users = (rng.normal(size=(num_users, d_random)) * 1.5).astype(np.float32)
    margin = x_fixed @ w_fixed + np.sum(x_random * w_users[user_of_row], axis=1)
    y = (1.0 / (1.0 + np.exp(-margin)) > rng.random(n)).astype(np.float32)
    return (_Data(response=y, user_of_row=user_of_row,
                  vocab=[f"u{i}" for i in range(num_users)]),
            {"x_fixed": x_fixed, "x_random": x_random})


def _game_example_schema() -> dict:
    """TrainingExampleAvro with two feature sections (fixedFeatures /
    userFeatures) and the entity id in metadataMap."""
    from photon_ml_tpu_torch.io import schemas

    return {
        "name": "GameExampleAvro",
        "namespace": "test",
        "type": "record",
        "fields": [
            {"name": "uid", "type": ["null", "string"], "default": None},
            {"name": "label", "type": "double"},
            {"name": "fixedFeatures",
             "type": {"type": "array", "items": schemas.FEATURE}},
            {"name": "userFeatures",
             "type": {"type": "array",
                      "items": "com.linkedin.photon.avro.generated.FeatureAvro"}},
            {"name": "metadataMap",
             "type": ["null", {"type": "map", "values": "string"}],
             "default": None},
            {"name": "weight", "type": ["null", "double"], "default": None},
            {"name": "offset", "type": ["null", "double"], "default": None},
        ],
    }


def _game_avro_records(data: _Data, rows, truth: Dict[str, np.ndarray],
                       offsets: Optional[np.ndarray] = None):
    """Rows as GameExampleAvro record dicts (nonzero features only)."""
    def feats(x_row, prefix):
        return [{"name": f"{prefix}{j}", "term": "", "value": float(v)}
                for j, v in enumerate(x_row) if v != 0.0]

    for r in rows:
        yield {
            "uid": str(r),
            "label": float(data.response[r]),
            "fixedFeatures": feats(truth["x_fixed"][r], "f"),
            "userFeatures": feats(truth["x_random"][r], "u"),
            "metadataMap": {"userId": data.vocab[data.user_of_row[r]]},
            "weight": None,
            "offset": float(offsets[r]) if offsets is not None else None,
        }


def _write_game_avro(path: str, data: _Data, rows, truth: Dict[str, np.ndarray],
                     offsets: Optional[np.ndarray] = None) -> None:
    from photon_ml_tpu_torch.io import avro as avro_io

    avro_io.write_container(path, _game_avro_records(data, rows, truth, offsets),
                            _game_example_schema())


def _save_synthetic_game_model(model_dir: str, rng, d_fixed: int, d_random: int,
                               num_users: int) -> None:
    """A random (untrained) GAME model in the reference layout: fixed effect
    'fixed' on shard 'global' (features f0..) and random effect 'per-user'
    on shard 'per_user' (features u0..) over users u0..u{num_users-1}."""
    from photon_ml_tpu_torch.io import model_io
    from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key
    from photon_ml_tpu_torch.types import TaskType

    fmap = IndexMap.build([feature_key(f"f{j}", "") for j in range(d_fixed)],
                          add_intercept=True)
    umap = IndexMap.build([feature_key(f"u{j}", "") for j in range(d_random)],
                          add_intercept=True)
    task = TaskType.LOGISTIC_REGRESSION
    w_fixed = rng.normal(size=len(fmap)).astype(np.float32)
    entity_means = {f"u{i}": rng.normal(size=len(umap)).astype(np.float32)
                    for i in range(num_users)}
    model_io.save_fixed_effect(model_dir, "fixed", task, w_fixed, fmap,
                               feature_shard_id="global")
    model_io.save_random_effect(model_dir, "per-user", task, entity_means, umap,
                                random_effect_id="userId", feature_shard_id="per_user")


def _serve_requests(records) -> list:
    """Record dicts as serve-protocol request rows (the features, ids and
    offset the batch driver reads from the Avro)."""
    return [{"features": {"fixedFeatures": rec["fixedFeatures"],
                          "userFeatures": rec["userFeatures"]},
             "ids": {"userId": (rec.get("metadataMap") or {}).get("userId")},
             "offset": rec.get("offset") or 0.0}
            for rec in records]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Day-in-the-life SLO harness on the card (see the module docstring)."
    )
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--phase-seconds", type=float, default=3.0)
    ap.add_argument("--peak-qps", type=float, default=120.0)
    ap.add_argument("--traffic-threads", type=int, default=3)
    ap.add_argument("--population", type=int, default=3_000_000)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--slo-scale", type=float, default=1.0)
    ap.add_argument(
        "--synthetic-models", action="store_true",
        help="skip the real delta retrain (fabricated generations)",
    )
    ap.add_argument("--no-kill-arm", action="store_true")
    ap.add_argument("--no-dtype-migration", action="store_true")
    ap.add_argument("--no-batch-oracle", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the fleet, the oracles and the retrain run "
                         "(default cuda; cuda without a card raises)")
    ap.add_argument(
        "--no-enforce", action="store_true",
        help="bank the ledger but do not fail on SLO violations",
    )
    args = ap.parse_args(argv)
    cfg = DayConfig(
        out_dir=args.out_dir,
        user_population=args.population,
        traffic_threads=args.traffic_threads,
        phase_seconds=args.phase_seconds,
        peak_qps=args.peak_qps,
        seed=args.seed,
        slo_scale=args.slo_scale,
        real_retrain=not args.synthetic_models,
        kill_arm=not args.no_kill_arm,
        dtype_migration=not args.no_dtype_migration,
        batch_oracle=not args.no_batch_oracle,
        device=args.device,
    )
    result = run_day(cfg, enforce=not args.no_enforce)
    led = result["ledger"]
    print(json.dumps({
        "ok": led["ok"],
        "violations_total": led["violations_total"],
        "totals": led["totals"],
        "ledger_path": result["ledger_path"],
    }, indent=1))
    return result


if __name__ == "__main__":
    main()
