"""Multi-process SPMD GAME training driver (port of
photon_ml_tpu/cli/game_multihost_driver.py).

Every process runs this SAME program, one process per device: it decodes
ONLY its share of the input part files (with the shared prebuilt feature
index, DataProcessingUtils.scala:57-80 semantics), ingests per host — the
collective shuffle routes random-effect rows to their entity's owner
(parallel/shuffle.py) and fixed-effect rows stay where they were decoded —
trains the coordinate descent over the per-host coordinates, and each
process writes its OWN part file of every random-effect model (the
coefficient blocks are never gathered); the coordinator writes the fixed
effect, the metadata and ``retrain.json``.

The cluster driver of the reference (cli/game/training/Driver.scala:537 on
Spark executors): the same flag grammar, SPMD instead of driver/executor.
Scope: the coordinate grid (best combo by the primary validation
evaluator; ``--grid-warm-start true`` seeds each combo from the previous
combo's coefficients), plain, bucketed and factored random effects under
the INDEX_MAP, RANDOM and IDENTITY projectors, ``--checkpoint-dir``
(resuming at the step every process can restore), ``--max-restarts``,
validation and ``retrain.json``. Feature maps must be prebuilt
(``--offheap-indexmap-dir`` or a name-and-term path).

``--streaming-random-effects`` runs the per-host streaming path
(parallel/perhost_streaming.py): the ranks agree the entity counts and the
blocking, route each random-effect row once to its block's owner, and each
rank builds and solves only its blocks under
``<output>/streaming-re/<name>/process-<rank>/`` (``--solve-compaction``
compacts each owned block, and is refused without streaming); the fixed
effect streams one chunk per input part file, each rank its own files'
chunks, the partials merged exactly, so the run is bitwise the single-host
streaming descent on the same chunks and blocking. ``--warm-start-from``
plans each rank's delta against the prior ``retrain.json`` and agrees it
across the ranks in one collective; any disagreement or failure makes
every rank train cold, recorded. With new or changed part files a
streaming random effect pins the prior blocking (``_agree_delta_pins``)
by the single-process delta build's rule (``retrain.delta.pin_prior_blocks``),
so its blocks without new or lost rows freeze, bitwise the prior model;
the JAX multihost driver freezes only a coordinate whose inputs are all
unchanged.

A streaming run relaunched onto its output dir (a fresh process on a dir
that holds a prior per-host layout, with ``--checkpoint-dir``; or an
in-process ``--max-restarts`` restart) keeps the dir and tries relaunch
adoption (parallel/elastic.relaunch_replan): every rank re-plans the prior
cohort's plan sidecars onto this cohort and copies in only the blocks and
spilled coefficients it now owns, and the fixed-effect files follow the
plan's re-based chunk ownership. The ranks vote; if any rank fails, every
rank re-ingests, recorded. An adopted coordinate's feature shard is not
decoded again (``decoded_shard_rows`` in the summary below).

Each process's ``photon-ml-tpu-mh-<I>.json`` also records the streaming
blocks it owned, the agreed delta-plan digest of a ``--warm-start-from``
run, the blocks it froze (by global id), and its streaming blocks'
executed lane-iterations.

Run (one process per device):

    python -m photon_ml_tpu_torch.cli.game_multihost_driver \\
        --multihost-coordinator HOST:PORT --multihost-num-processes N \\
        --multihost-process-id I  <game training flags...>

The backend follows the job's topology (parallel/multihost.py). Each
process also writes ``photon-ml-tpu-mh-<I>.json`` beside its
log: its backend, device, wall, the launches of each kernel, and the
epoch seconds at which ``main`` was entered, the run started (after the
flags were parsed and checked) and the run finished: what a launcher needs
to split a process's life into start-up, set-up, run and exit.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.cli.game_params import CoordinateOptConfig, parse_training_params
from photon_ml_tpu_torch.device import enable_determinism
from photon_ml_tpu_torch.io import model_io
from photon_ml_tpu_torch.io.avro_data import read_game_data
from photon_ml_tpu_torch.ops import losses as losses_mod
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.optim.common import OptResult
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.parallel import multihost
from photon_ml_tpu_torch.parallel.distributed import DistributedFixedEffectSolver
from photon_ml_tpu_torch.parallel.mesh import MeshContext
from photon_ml_tpu_torch.parallel.perhost_ingest import (
    BucketedShardedREData,
    HostRows,
    _unpack_u64,
    concat_host_rows,
    csr_to_padded,
    global_row_layout,
    host_file_share,
    merge_group_ids,
    merge_row_vectors,
    per_host_re_dataset,
)
from photon_ml_tpu_torch.parallel.shuffle import collective_sum
from photon_ml_tpu_torch.resilience import preemption
from photon_ml_tpu_torch.utils.logging import PhotonLogger

Tensor = torch.Tensor

MH_FLAGS = ("--multihost-coordinator", "--multihost-num-processes", "--multihost-process-id",
            "--grid-warm-start")


def _local_game_data(gds, shard: str, dim: int):
    """This host's decoded files as one GameData of one feature shard (CSR
    rows concatenated in file order)."""
    from photon_ml_tpu_torch.data.game import GameData, HostFeatures

    indptr, base = [np.zeros(1, np.int64)], 0
    for _, gd in gds:
        f = gd.shards[shard]
        indptr.append(np.asarray(f.indptr[1:], np.int64) + base)
        base += int(f.indptr[-1])
    cat = lambda arrays, dtype: (np.concatenate(arrays) if arrays else np.zeros(0, dtype))
    feats = HostFeatures(indptr=np.concatenate(indptr),
                         indices=cat([gd.shards[shard].indices for _, gd in gds], np.int32),
                         values=cat([gd.shards[shard].values for _, gd in gds], np.float32),
                         dim=dim)
    return GameData(response=cat([gd.response for _, gd in gds], np.float32),
                    offset=cat([gd.offset for _, gd in gds], np.float32),
                    weight=cat([gd.weight for _, gd in gds], np.float32),
                    ids={}, id_vocabs={}, shards={shard: feats})


class MultihostFixedEffectCoordinate:
    """Fixed-effect coordinate over per-host row blocks (drop-in for
    CoordinateDescent): rows stay where they were decoded, the solve is the
    distributed one (each rank's fused or plain pass, then the fixed-order
    sum), and scoring scatters this rank's margins into the global (N,)
    vector merged by one fixed-order sum (each row is scored by one rank)."""

    def __init__(self, batch: GLMBatch, row_ids: np.ndarray, num_rows: int,
                 problem: GLMOptimizationProblem, ctx: MeshContext):
        self.ctx = ctx
        self.num_rows = num_rows
        self.batch = batch
        self.row_ids = torch.from_numpy(np.asarray(row_ids, np.int64)).to(batch.device)
        self.norm = NormalizationContext.identity()
        self.solver = DistributedFixedEffectSolver(problem, ctx)

    @property
    def problem(self) -> GLMOptimizationProblem:
        return self.solver.problem

    @property
    def dim(self) -> int:
        return self.batch.dim

    def initial_coefficients(self) -> Tensor:
        return torch.zeros((self.dim,), dtype=self.batch.labels.dtype, device=self.batch.device)

    def update(self, residual_offsets: Tensor, init_coefficients: Tensor,
               reg_weight: Optional[float] = None) -> Tuple[Tensor, OptResult]:
        # residuals arrive in GLOBAL row order; take this rank's rows
        b = self.batch
        batch = GLMBatch(b.features, b.labels, b.offsets + residual_offsets[self.row_ids],
                         b.weights)
        model, result = self.solver.run(batch, self.norm, init_coefficients, reg_weight)
        return model.coefficients.means, result

    def score(self, coefficients: Tensor) -> Tensor:
        out = torch.zeros((self.num_rows,), dtype=coefficients.dtype,
                          device=coefficients.device)
        out[self.row_ids] = self.batch.features.matvec(coefficients)
        return self.ctx.sum(out)

    def regularization_term(self, coefficients: Tensor,
                            reg_weight: Optional[float] = None) -> Tensor:
        return self.problem.regularization_term_value(coefficients, reg_weight)

    def rebind(self, problem: GLMOptimizationProblem) -> "MultihostFixedEffectCoordinate":
        """A coordinate sharing this one's device-resident rows but solving
        another problem (the combo grid uploads the rows once)."""
        import copy

        c = copy.copy(self)
        c.solver = DistributedFixedEffectSolver(problem, self.ctx)
        return c


def _add_multihost_flags(argv: List[str]) -> Tuple[dict, List[str]]:
    """Strip the --multihost-* / --grid-warm-start flags; the rest is the
    GAME training grammar."""
    mh_args = {"coordinator": None, "num_processes": None, "process_id": None,
               "grid_warm_start": False}
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a not in MH_FLAGS:
            rest.append(a)
            i += 1
            continue
        if i + 1 >= len(argv):
            raise ValueError(f"{a} requires a value")
        value = argv[i + 1]
        if a == "--multihost-coordinator":
            mh_args["coordinator"] = value
        elif a == "--multihost-num-processes":
            mh_args["num_processes"] = int(value)
        elif a == "--multihost-process-id":
            mh_args["process_id"] = int(value)
        else:
            mh_args["grid_warm_start"] = value.strip().lower() in ("true", "1", "yes")
        i += 2
    return mh_args, rest


def main(argv: Optional[List[str]] = None) -> dict:
    """Train on this process's share; every process of the job calls it."""
    entered_at = time.time()
    enable_determinism()
    mh_args, rest = _add_multihost_flags(list(argv) if argv is not None else sys.argv[1:])
    p = parse_training_params(rest)
    _check_multihost_support(p)
    # SPMD preemption: every process observes the same request and drains at
    # the same update boundary, so the emergency checkpoint's collectives
    # stay aligned; a relaunch re-ingests and resumes at the agreed step
    try:
        with preemption.signal_scope():
            try:
                return preemption.run_with_restarts(
                    lambda attempt: _main_once(mh_args, p, entered_at, restart=attempt > 0),
                    p.max_restarts)
            except preemption.Preempted as e:
                print(f"photon-ml-tpu-torch multihost: preempted ({e}); exiting "
                      f"{preemption.PREEMPT_EXIT_CODE}", file=sys.stderr)
                raise SystemExit(preemption.PREEMPT_EXIT_CODE) from e
    finally:
        multihost.shutdown()


def _check_multihost_support(p) -> None:
    """Scope checks (testable without launching processes): flags this
    driver does not implement are refused, never ignored."""
    unsupported = [flag for flag, on in (
        ("--compute-variance", p.compute_variance),
        ("--vmapped-grid", p.vmapped_grid != "false"),
    ) if on]
    if unsupported:
        raise ValueError(
            f"multihost driver does not implement {unsupported} — rejecting rather than "
            "silently ignoring (the coefficient blocks are per process, so one compiled "
            "cycle over the whole grid cannot hold them)")
    from photon_ml_tpu_torch.optim.scheduler import resolve_schedule

    if resolve_schedule(p.solve_compaction) is not None and not p.streaming_random_effects:
        raise ValueError(
            "multihost driver composes --solve-compaction with --streaming-random-effects "
            "(each host compacts its owned blocks; updates are owner-computes, no "
            "collective) — the in-memory per-host random-effect solver runs one-shot; add "
            "--streaming-random-effects or drop --solve-compaction")


def _streaming_names(p) -> List[str]:
    """The per-host streaming random effects, in updating order."""
    return [n for n in p.updating_sequence
            if n in p.random_effect_data_configs and n not in p.factored_configs]


def _prior_layout_dirs(p) -> List[str]:
    """The committed ``process-<r>`` manifest dirs of the first streaming
    random effect's layout under the output dir (empty without one)."""
    names = _streaming_names(p)
    root = os.path.join(p.output_dir, "streaming-re", names[0]) if names else None
    if not root or not os.path.isdir(root):
        return []
    return [os.path.join(root, d) for d in sorted(os.listdir(root))
            if d.startswith("process-") and os.path.isfile(os.path.join(root, d, "manifest.json"))]


def _is_relaunch(p) -> bool:
    """A fresh process started on an output dir that holds a prior per-host
    streaming layout and a checkpoint dir: a supervised relaunch, which keeps
    the dir (its blocks, spilled state and checkpoints are the resume)."""
    return bool(p.streaming_random_effects and p.checkpoint_dir
                and os.path.isdir(p.checkpoint_dir) and _prior_layout_dirs(p))


def _epoch_floor(state_root: str) -> int:
    """The highest ``epoch-N`` spill dir under ``state_root`` (0 without
    one): a relaunched coordinate numbers its epochs above it, so its spills
    never overwrite the ones the restored checkpoint references."""
    if not os.path.isdir(state_root):
        return 0
    return max([int(d.split("-", 1)[1]) for d in os.listdir(state_root)
                if d.startswith("epoch-") and d.split("-", 1)[1].isdigit()], default=0)


def _attempt_relaunch_adoption(p, mh, ctx, logger) -> Dict[str, object]:
    """The relaunch re-plan (``parallel.elastic.relaunch_replan``) of every
    streaming random effect: read the prior cohort's plan sidecars, re-plan
    onto this cohort and copy only the moved block and state files, so a
    relaunch onto a smaller or larger cohort resumes instead of
    re-ingesting.

    Returns ``{coordinate: RelaunchReplanResult}`` only when every rank
    adopted every coordinate (one unanimous vote: 0 failed, 1 adopted, 2
    same cohort). A failure anywhere, or a same-cohort restart (which needs
    no re-plan), returns ``{}`` on every rank, and every rank re-ingests."""
    import re

    from photon_ml_tpu_torch.parallel.elastic import ElasticError, relaunch_replan
    from photon_ml_tpu_torch.parallel.perhost_streaming import load_plan_sidecars
    from photon_ml_tpu_torch.parallel.shuffle import collective_max

    names = _streaming_names(p)
    state_base = os.path.join(p.output_dir, "streaming-re-state")
    adopted: Dict[str, object] = {}
    code, why = 1, ""
    try:
        prior_cohort = None
        dirs = _prior_layout_dirs(p)
        meta = load_plan_sidecars(dirs[0])[0] if dirs else None
        if meta is not None:
            prior_cohort = sorted({int(q) for q in meta["binding"].values()})
        if prior_cohort is None:
            code, why = 0, "no committed plan-versioned prior layout"
        elif prior_cohort == list(range(mh.num_processes)):
            code = 2
        else:
            for name in names:
                # the prior spill roots by old rank, one group per state
                # instance (the -<seq> suffix), each paired with this rank's
                # root of the same instance
                pairs = []
                if os.path.isdir(state_base):
                    pat = re.compile(re.escape(name) + r"-host(\d+)-(\d+)$")
                    by_seq: Dict[int, Dict[int, str]] = {}
                    for d in os.listdir(state_base):
                        m = pat.match(d)
                        if m:
                            by_seq.setdefault(int(m.group(2)), {})[int(m.group(1))] = \
                                os.path.join(state_base, d)
                    pairs = [(srcs, os.path.join(state_base, f"{name}-host{mh.process_id}-{seq}"))
                             for seq, srcs in sorted(by_seq.items())]
                adopted[name] = relaunch_replan(
                    os.path.join(p.output_dir, "streaming-re", name), mh.process_id,
                    mh.num_processes, state_root_pairs=pairs)
    except (ElasticError, OSError, ValueError, KeyError) as e:
        code, why = 0, f"{type(e).__name__}: {e}"
        adopted = {}
    # every rank votes, failed or not: a mixed resume would strand the
    # routing collectives, so all adopt or all re-ingest
    v = np.asarray([code], np.int64)
    vmax = int(collective_max(v, ctx, mh.num_processes)[0])
    vmin = -int(collective_max(-v, ctx, mh.num_processes)[0])
    if vmax != vmin or vmin != 1:
        if vmax == vmin == 2:
            logger.info("relaunch: same cohort as the prior run — plain resume from the "
                        "plan-versioned checkpoints, no re-plan needed")
        else:
            logger.warn("relaunch re-plan unavailable on at least one host"
                        + (f" (here: {why})" if code != 1 else "")
                        + " — full re-ingest on the new cohort (recorded decision)")
        return {}
    for name, res in adopted.items():
        logger.info(f"relaunch: adopted {name} at plan v{res.plan.version}: "
                    f"{len(res.adopted)} blocks and {res.state_files_adopted} state files "
                    f"copied onto process {mh.process_id}, {len(res.moved)}/"
                    f"{len(res.plan.owners)} blocks moved")
    return adopted


def _fe_chunk_share(all_files, adopted, mh, logger):
    """This host's input-file share. An adopted re-plan carries the prior
    run's fixed-effect chunk ownership re-based onto the new cohort (chunk c
    is input file c, versioned with the plan); otherwise the positional
    share."""
    if adopted:
        result = next(iter(adopted.values()))
        shard_plan = result.plan
        own = getattr(shard_plan, "fe_chunk_owners", None)
        if own is not None and len(own) == len(all_files):
            chunks = shard_plan.owned_fe_chunks(mh.process_id, membership=result.membership)
            logger.info(f"host {mh.process_id}: FE chunk ownership from re-based plan "
                        f"v{shard_plan.version} ({len(chunks)}/{len(all_files)} chunks)")
            return [(all_files[int(c)], int(c)) for c in chunks]
        logger.info("adopted plan has no usable FE chunk ownership — positional file share "
                    "(chunk merge is exact either way; ownership only balances the streaming "
                    "fixed-effect load)")
    return host_file_share(all_files, mh.num_processes, mh.process_id)


def _attach_fe_ownership(mh, all_files, g_file_counts, streaming_manifests, logger) -> None:
    """A fresh ingest records the per-host file split it used (chunk c is
    input file c) into every streaming coordinate's plan sidecars, so a
    later relaunch re-plan re-bases fixed-effect chunks as it does blocks."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import attach_fe_chunks_to_sidecars

    owners = np.zeros(len(all_files), np.int32)
    for pid in range(mh.num_processes):
        for _, ordinal in host_file_share(all_files, mh.num_processes, pid):
            owners[ordinal] = pid
    for name, sm in streaming_manifests.items():
        try:
            attach_fe_chunks_to_sidecars(sm.dir, owners, g_file_counts)
        except (OSError, ValueError) as e:
            logger.warn(f"streaming RE {name}: could not record FE chunk ownership in the plan "
                        f"sidecars ({e}) — a relaunch re-plan falls back to the positional "
                        "file share")


def _fe_chunk_loaders(gds, shard: str, dim: int) -> Dict[int, object]:
    """One fixed-effect chunk per decoded input file, densified inside its
    loader: one dense chunk is resident at a time, the CSR shards persist."""
    loaders: Dict[int, object] = {}
    for ordinal, gd in gds:
        f = gd.shards[shard]

        def load(f=f, gd=gd):
            dense = np.zeros((gd.num_rows, dim), np.float32)
            dense[np.repeat(np.arange(gd.num_rows), np.diff(f.indptr)), f.indices] = f.values
            return {"x": dense, "y": gd.response.astype(np.float32),
                    "offsets": gd.offset.astype(np.float32),
                    "weights": gd.weight.astype(np.float32)}

        loaders[ordinal] = load
    return loaders


def _agree_digest(canon: Optional[str], ctx, num_processes: int) -> Optional[int]:
    """One collective vote on a rank's outcome: the SHA-256 of ``canon`` as
    a non-negative int63, or the poison value -1 where ``canon`` is None
    (this rank failed). Returns the digest every rank holds, None when any
    rank failed or two disagree; every rank votes whatever happened."""
    from photon_ml_tpu_torch.parallel.shuffle import collective_max

    digest = (-1 if canon is None
              else int.from_bytes(hashlib.sha256(canon.encode()).digest()[:8], "big") >> 1)
    d = np.asarray([digest], np.int64)
    dmax = int(collective_max(d, ctx, num_processes)[0])
    dmin = -int(collective_max(-d, ctx, num_processes)[0])
    return dmin if dmax == dmin and dmin >= 0 else None


def _agree_delta_pins(p, mh, ctx, logger, all_files, id_types) -> Dict[str, tuple]:
    """``--warm-start-from`` with streaming: each streaming random effect's
    prior plan (its coordinator manifest's sidecars), the prior vocabulary,
    the prior per-entity row counts and the dirty entities (raw ids with
    rows in a new or changed file), which pin the prior blocking
    (``perhost_streaming.pin_prior_blocking``, the single-process delta
    build's rule) so that a delta retrain can freeze its unchanged blocks.
    Every rank reads the same files; one vote compares a digest of the
    outcome, and any disagreement or failure builds the fresh blocking
    everywhere (the routing collectives need one blocking). Returns
    {coordinate: (prior plan, prior vocab, prior row counts, dirty raw ids)}."""
    if not p.warm_start_from or not p.streaming_random_effects:
        return {}
    from photon_ml_tpu_torch import retrain
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        EntityShardPlan,
        PerHostStreamingManifest,
        load_plan_entity_rows,
    )

    pins: Dict[str, tuple] = {}
    canon, why = None, ""
    try:
        prior = retrain.load_prior_manifest(p.warm_start_from)
        files = retrain.diff_files(prior.stat_by_path(), all_files)
        dirty = retrain.probe_dirty_entities(files, id_types)
        for name, dc in p.random_effect_data_configs.items():
            rec = prior.coordinates.get(name)
            if (name in p.factored_configs or rec is None or rec.kind != "streaming_random"
                    or not rec.streaming_manifest_dir):
                continue
            prior_plan = EntityShardPlan.from_sidecars(rec.streaming_manifest_dir)
            prior_rows = load_plan_entity_rows(rec.streaming_manifest_dir)
            if prior_plan is None or prior_rows is None:
                continue
            prior_vocab = PerHostStreamingManifest.load(rec.streaming_manifest_dir).vocab
            pins[name] = (prior_plan, prior_vocab, prior_rows,
                          set(dirty.get(dc.random_effect_id, ())))
        canon = json.dumps({n: [int(pin[0].version), len(pin[0].blocks),
                                retrain.dirty_set_digest(pin[3])]
                            for n, pin in sorted(pins.items())}, sort_keys=True)
    except Exception as e:  # noqa: BLE001 — an unusable prior builds the fresh blocking (the warm agreement then decides the run), never one rank pinned alone
        pins, why = {}, f"{type(e).__name__}: {e}"
    if _agree_digest(canon, ctx, mh.num_processes) is None:
        logger.warn("delta retrain: the prior blocking is not pinned on every host"
                    + (f" (here: {why})" if why else "") + " — fresh blocking everywhere")
        return {}
    for name, pin in sorted(pins.items()):
        logger.info(f"delta retrain [{name}]: prior blocking pinned, {len(pin[3])} dirty entities")
    return pins


def _build_streaming_manifest(p, plan, mh, ctx, name, dc, rows, all_files, logger, pin=None,
                              pin_status=None):
    """The per-host streaming ingest of one random effect: agree, plan,
    route, build the owned blocks (through a shard-scoped tensor cache with
    ``--tensor-cache``). ``pin`` (``_agree_delta_pins``' entry) pins the
    prior blocking, and the blocks' statuses by global id (after any
    re-block of an outgrown pinned block) go to ``pin_status[name]``.
    Returns (manifest, cache key)."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        build_perhost_streaming_manifest,
        pin_prior_blocking,
    )

    budget = int(p.re_memory_budget_mb * 1e6) if p.re_memory_budget_mb is not None else None
    block_entities = None if budget is not None else 1024
    pinned = None
    if pin is not None:
        prior_plan, prior_vocab, prior_rows, dirty_raw = pin

        def pinned(vocab, counts):
            blocks, statuses = pin_prior_blocking(
                prior_plan, prior_vocab, prior_rows, vocab, counts, dirty_raw,
                global_dim=rows.global_dim, active_upper_bound=dc.active_upper_bound,
                block_entities=block_entities, memory_budget_bytes=budget)
            # the build updates the list in place if it re-blocks a pin
            pin_status[name] = statuses
            return blocks, statuses

    cache = cache_key = None
    if p.tensor_cache_dir and pin is None:
        from photon_ml_tpu_torch.io.tensor_cache import TensorCache, process_shard_scope

        cache = TensorCache(p.tensor_cache_dir,
                            shard_scope=process_shard_scope(mh.process_id, mh.num_processes))
        bk = plan.bucketer
        # keyed on the global file list: this rank's blocks hold rows routed
        # from every rank's files, so a peer's input change must miss here
        cache_key = cache.key_for(all_files, {
            "kind": "perhost_streaming_re_blocks", "coord": name, "config": str(dc),
            "budget": budget, "n_files": len(all_files),
            "ladder": f"{bk.base}:{bk.growth:g}" if bk is not None else None})
    manifest = build_perhost_streaming_manifest(
        rows, dc, os.path.join(p.output_dir, "streaming-re", name, f"process-{mh.process_id}"),
        ctx, mh.num_processes, mh.process_id,
        block_entities=block_entities, memory_budget_bytes=budget,
        # "off", never None: the plan already read PHOTON_SHAPE_LADDER
        bucketer=plan.bucketer or "off", tensor_cache=cache, cache_key=cache_key, pin=pinned)
    logger.info(f"streaming RE {name}: host {mh.process_id} owns {len(manifest.blocks)}/"
                f"{manifest.num_blocks_total} blocks {manifest.global_block_ids}")
    return manifest, cache_key


def _shard_maps(p, needed_shards) -> Dict[str, object]:
    """The prebuilt, shared feature maps (a full-data scan on every host
    would defeat per-host ingest)."""
    maps = {}
    for shard in needed_shards:
        if p.offheap_indexmap_dir:
            from photon_ml_tpu_torch.io.offheap import load_shard_index_map

            maps[shard] = load_shard_index_map(p.offheap_indexmap_dir, shard)
        elif p.feature_name_and_term_set_path:
            from photon_ml_tpu_torch.io.name_and_term import NameAndTermFeatureSetContainer

            all_sections = sorted({s for secs in p.feature_shard_sections.values() for s in secs})
            nt = NameAndTermFeatureSetContainer.read_from_text(
                p.feature_name_and_term_set_path, all_sections)
            maps[shard] = nt.index_map(p.feature_shard_sections.get(shard) or ["features"],
                                       p.feature_shard_intercepts.get(shard, True))
        else:
            raise ValueError(
                "multihost ingest needs prebuilt feature maps: pass --offheap-indexmap-dir "
                "(FeatureIndexingJob output) or --feature-name-and-term-set-path")
    return maps


def _decode_share(p, share, shard_maps, needed_shards, id_types, response_required=True):
    """[(global ordinal, GameData)] of this host's ``share`` [(file,
    global ordinal)], decoding only the ``needed_shards``."""
    gds = []
    for f, ordinal in share:
        gds.append((ordinal, read_game_data(
            [f], {s: shard_maps[s] for s in needed_shards},
            {s: p.feature_shard_sections.get(s) or ["features"] for s in needed_shards},
            id_types,
            shard_intercepts={s: p.feature_shard_intercepts.get(s, True) for s in needed_shards},
            response_required=response_required)))
    return gds


def _host_rows(gds, file_base, shard: str, id_name: str, global_dim: int) -> HostRows:
    parts = []
    for ordinal, gd in gds:
        f = gd.shards[shard]
        fi, fv = csr_to_padded(f, gd.num_rows)
        vocab = gd.id_vocabs[id_name]
        parts.append(HostRows(
            entity_raw_ids=[vocab[i] for i in gd.ids[id_name]],
            row_index=file_base[ordinal] + np.arange(gd.num_rows, dtype=np.int64),
            labels=np.nan_to_num(gd.response).astype(np.float32),
            weights=gd.weight.astype(np.float32), offsets=gd.offset.astype(np.float32),
            feat_idx=fi, feat_val=fv, global_dim=f.dim))
    return concat_host_rows(parts, global_dim)


def kernel_launches() -> Dict[str, int]:
    """This process's launches of each kernel so far (the wrappers count
    where they launch)."""
    from photon_ml_tpu_torch.ops import fused_glm, fused_sparse

    return {"fused_glm": fused_glm.fused_value_grad_kernel.launches,
            "gevm": fused_sparse.sparse_gevm_kernel.launches,
            "hvp": fused_sparse.sparse_hvp_kernel.launches}


def _main_once(mh_args: dict, p, entered_at: float, restart: bool = False) -> dict:
    from photon_ml_tpu_torch.cli.game_training_driver import io_resilience_config

    t_start, started_at = time.perf_counter(), time.time()
    mh = multihost.initialize(mh_args["coordinator"], mh_args["num_processes"],
                              mh_args["process_id"], device=p.device)
    ctx = mh.mesh_context()
    with resilience.resilience_scope(io_resilience_config(
            p.on_corrupt, p.corrupt_skip_budget, p.io_retries, p.io_retry_base_delay)):
        out = _train(mh_args, p, mh, ctx, restart)
    from photon_ml_tpu_torch.optim.scheduler import solve_stats

    out["wall_s"] = time.perf_counter() - t_start
    out["launches"] = kernel_launches()
    # the streaming blocks' executed lane-iterations in this process
    out["block_lane_iterations"] = sum(e["executed"] for e in solve_stats.block_totals().values())
    out["entered_at"], out["started_at"], out["finished_at"] = (entered_at, started_at,
                                                                time.time())
    with open(os.path.join(p.output_dir, f"photon-ml-tpu-mh-{mh.process_id}.json"), "w") as f:
        json.dump({k: out[k] for k in ("process_id", "num_processes", "backend", "device",
                                       "wall_s", "launches", "objective_history",
                                       "validation_metrics", "num_rows", "entered_at",
                                       "started_at", "finished_at", "streaming_blocks",
                                       "delta_digest", "frozen_blocks",
                                       "block_lane_iterations", "decoded_shard_rows",
                                       "adopted")}, f,
                  default=str)
    return out


def _train(mh_args: dict, p, mh, ctx: MeshContext, restart: bool) -> dict:
    from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.cli.game_training_driver import (
        _default_evaluators,
        _input_files,
        _summarize_tracker,
        resolve_date_range_dirs,
    )
    from photon_ml_tpu_torch.compile.plan import ExecutionPlan
    from photon_ml_tpu_torch.data.game import build_fixed_effect_batch
    from photon_ml_tpu_torch.evaluation.evaluators import evaluator_for
    from photon_ml_tpu_torch.io.tensor_cache import file_stat_token

    # the coordinator owns the output dir's lifecycle (stale per-host part
    # files of another topology must never merge into a reloaded model);
    # a supervised relaunch keeps the dir (its checkpoints are the resume)
    restart = restart or _is_relaunch(p)
    if mh.coordinator_only_io():
        from photon_ml_tpu_torch.utils.io_utils import prepare_output_dir

        if restart:
            os.makedirs(p.output_dir, exist_ok=True)
        else:
            prepare_output_dir(p.output_dir, p.delete_output_dir_if_exists)
    mh.barrier("output-dir")
    logger = PhotonLogger(os.path.join(p.output_dir, f"photon-ml-tpu-mh-{mh.process_id}.log"))
    logger.info(f"multihost: process {mh.process_id} of {mh.num_processes}, backend "
                f"{ctx.backend}, device {ctx.device}")
    plan = ExecutionPlan.resolve(
        shape_canonicalization=p.shape_canonicalization, solve_compaction=p.solve_compaction,
        adaptive_schedule=p.adaptive_schedule, distributed=True,
        streaming=p.streaming_random_effects, bucketed=p.bucketed_random_effects, plan=p.plan,
        num_processes=mh.num_processes)
    logger.info(plan.describe())
    for line in plan.describe_decisions():
        logger.info(f"execution plan: {line}")
    for cname, dc in p.random_effect_data_configs.items():
        proj = dc.projector.upper()
        if proj not in ("INDEX_MAP", "IDENTITY", "RANDOM"):
            raise ValueError(f"coordinate {cname!r} requests unknown projector {dc.projector!r}")
        if proj == "RANDOM" and dc.random_projection_dim is None:
            raise ValueError(f"coordinate {cname!r}: RANDOM projector needs "
                             "random_projection_dim in its data configuration")
    combos = p.config_grid()

    # ---- feature maps: prebuilt, shared, mmap'd -----------------------------
    needed_shards = ({c.feature_shard_id for c in p.fixed_effect_data_configs.values()}
                     | {c.feature_shard_id for c in p.random_effect_data_configs.values()})
    shard_maps = _shard_maps(p, needed_shards)

    # ---- per-host decode ----------------------------------------------------
    # _input_files is deterministic and identical on every host: no global
    # re-sort, so the row order is the single-process driver's
    all_files = _input_files(resolve_date_range_dirs(
        p.train_input_dirs, p.train_date_range, p.train_date_range_days_ago))
    train_file_stats = file_stat_token(all_files)
    # a relaunch onto another cohort adopts the prior layout (re-plan, copy
    # only the moved files); any rank failing makes every rank re-ingest
    adopted: Dict[str, object] = {}
    adoption_s = 0.0
    if restart and p.streaming_random_effects:
        t_adopt = time.perf_counter()
        adopted = _attempt_relaunch_adoption(p, mh, ctx, logger)
        adoption_s = time.perf_counter() - t_adopt
    host_files = _fe_chunk_share(all_files, adopted, mh, logger)
    id_types = sorted({c.random_effect_id for c in p.random_effect_data_configs.values()})
    # an adopted coordinate's blocks are on disk: its shard and entity ids
    # are not decoded again
    fresh_re = [dc for n, dc in p.random_effect_data_configs.items() if n not in adopted]
    train_shards = ({c.feature_shard_id for c in p.fixed_effect_data_configs.values()}
                    | {dc.feature_shard_id for dc in fresh_re})
    gds = _decode_share(p, host_files, shard_maps, train_shards,
                        sorted({dc.random_effect_id for dc in fresh_re}))
    # the rows the decode gave each feature shard (an adopted coordinate's
    # shard gets none)
    decoded_shard_rows = {s: sum(gd.num_rows for _, gd in gds if s in gd.shards)
                          for s in sorted({s for _, gd in gds for s in gd.shards})}
    file_base, n_global = global_row_layout(len(all_files), gds, ctx, mh.num_processes)
    logger.info(f"host {mh.process_id}: {len(gds)}/{len(all_files)} files, "
                f"{sum(gd.num_rows for _, gd in gds)}/{n_global} rows")

    def assemble_global(vec_per_gd) -> Tensor:
        merged = merge_row_vectors(gds, file_base, n_global, ctx, mh.num_processes, vec_per_gd)
        return torch.from_numpy(np.asarray(merged)).to(ctx.device)

    labels_g = assemble_global(lambda gd: gd.response.astype(np.float32))
    weights_g = assemble_global(lambda gd: gd.weight.astype(np.float32))
    offsets_g = assemble_global(lambda gd: gd.offset.astype(np.float32))

    # ---- datasets, built once (combo-invariant) ------------------------------
    fe_coords: Dict[str, MultihostFixedEffectCoordinate] = {}
    fe_chunks: Dict[str, tuple] = {}  # streaming: (chunk sizes, owned loaders, dim)
    re_datasets: Dict[str, object] = {}
    streaming_manifests: Dict[str, object] = {}
    coord_cache_keys: Dict[str, Optional[str]] = {}
    # per-file row counts, the same on every rank: the streaming fixed
    # effect's global chunk grid (chunk c is input file c)
    g_file_counts = np.diff(np.append(file_base, n_global)).astype(np.int64)
    pins = _agree_delta_pins(p, mh, ctx, logger, all_files, id_types)
    pin_status: Dict[str, List[str]] = {}  # streaming coordinate -> status by global block
    for name in p.updating_sequence:
        if name in p.fixed_effect_data_configs:
            spec = p.fixed_effect_data_configs[name]
            if p.streaming_random_effects:
                dim = len(shard_maps[spec.feature_shard_id])
                fe_chunks[name] = ([int(c) for c in g_file_counts],
                                   _fe_chunk_loaders(gds, spec.feature_shard_id, dim), dim)
                continue
            local = _local_game_data(gds, spec.feature_shard_id,
                                     len(shard_maps[spec.feature_shard_id]))
            batch = build_fixed_effect_batch(local, spec.feature_shard_id, dense=True,
                                             device=ctx.device)
            row_ids = np.concatenate([file_base[o] + np.arange(gd.num_rows) for o, gd in gds]
                                     ) if gds else np.zeros(0, np.int64)
            default = CoordinateOptConfig()
            fe_coords[name] = MultihostFixedEffectCoordinate(
                batch, row_ids, n_global,
                GLMOptimizationProblem(p.task_type, default.optimizer, default.optimizer_config(),
                                       default.regularization_context()), ctx)
            continue
        dc = p.random_effect_data_configs[name]
        if name in p.factored_configs and dc.projector.upper() != "IDENTITY":
            raise ValueError(
                f"factored coordinate {name!r} requires an IDENTITY projector in its data "
                f"config (got {dc.projector!r}) — the latent matrix projects the global "
                "shard space")
        if name in adopted:
            # the re-based manifest is this run's ingest: no row is routed
            streaming_manifests[name], coord_cache_keys[name] = adopted[name].manifest, None
            logger.info(f"streaming RE {name}: adopted relaunch re-plan "
                        f"v{adopted[name].plan.version} — host {mh.process_id} owns "
                        f"{len(adopted[name].manifest.blocks)}/"
                        f"{adopted[name].manifest.num_blocks_total} blocks, no re-ingest")
            continue
        rows = _host_rows(gds, file_base, dc.feature_shard_id, dc.random_effect_id,
                          len(shard_maps[dc.feature_shard_id]))
        if p.streaming_random_effects and name not in p.factored_configs:
            streaming_manifests[name], coord_cache_keys[name] = _build_streaming_manifest(
                p, plan, mh, ctx, name, dc, rows, all_files, logger, pins.get(name), pin_status)
            continue
        bucketed = p.bucketed_random_effects and name not in p.factored_configs
        re_datasets[name] = per_host_re_dataset(
            rows, ctx, mh.num_processes, mh.process_id,
            active_upper_bound=dc.active_upper_bound, size_buckets=8 if bucketed else 1,
            projector=dc.projector.upper(), projection_dim=dc.random_projection_dim,
            projection_seed=dc.seed, projection_keep_intercept=dc.random_projection_intercept)
        logger.info(f"random effect {name}: {re_datasets[name].num_entities} entities, "
                    f"{re_datasets[name].entities_per_device} lanes on this process")
    if streaming_manifests and not adopted:
        _attach_fe_ownership(mh, all_files, g_file_counts, streaming_manifests, logger)

    # ---- --warm-start-from: every rank plans its delta, one collective agrees
    warm_init, frozen_blocks, frozen_names, delta_digest = _prepare_multihost_warm(
        p, mh, ctx, logger, plan, shard_maps, all_files, streaming_manifests, combos, pin_status)
    stream_state_seq = [0]

    def build_coords(combo: Dict[str, CoordinateOptConfig]) -> Dict[str, object]:
        from photon_ml_tpu_torch.algorithm.factored_random_effect import MFOptimizationConfig
        from photon_ml_tpu_torch.algorithm.streaming_fixed_effect import (
            PerHostStreamingFixedEffectCoordinate,
        )
        from photon_ml_tpu_torch.parallel.perhost_factored import (
            PerHostFactoredRandomEffectCoordinate,
        )
        from photon_ml_tpu_torch.parallel.perhost_ingest import (
            PerHostBucketedRandomEffectSolver,
            PerHostRandomEffectSolver,
        )
        from photon_ml_tpu_torch.parallel.perhost_streaming import (
            PerHostStreamingRandomEffectCoordinate,
        )

        coords: Dict[str, object] = {}
        for name in p.updating_sequence:
            cfg = combo.get(name, CoordinateOptConfig())
            if name in fe_chunks:
                chunk_sizes, owned_loaders, dim = fe_chunks[name]
                coords[name] = PerHostStreamingFixedEffectCoordinate(
                    chunk_sizes, owned_loaders, dim,
                    GLMOptimizationProblem(p.task_type, cfg.optimizer, cfg.optimizer_config(),
                                           cfg.regularization_context()),
                    ctx=ctx, num_processes=mh.num_processes, plan=plan, device=ctx.device)
            elif name in streaming_manifests:
                stream_state_seq[0] += 1
                state_root = os.path.join(p.output_dir, "streaming-re-state",
                                          f"{name}-host{mh.process_id}-{stream_state_seq[0]}")
                coords[name] = PerHostStreamingRandomEffectCoordinate(
                    manifest=streaming_manifests[name], task=p.task_type,
                    optimizer=cfg.optimizer, optimizer_config=cfg.optimizer_config(),
                    regularization=cfg.regularization_context(),
                    # spilled state per rank and combo, under this run's
                    # output dir (never inside a shared cache entry); a
                    # relaunch numbers its epochs above the restored ones
                    state_root=state_root, initial_epoch=_epoch_floor(state_root),
                    # the schedule, the per-block sparse race, the depth
                    plan=plan, device=ctx.device, ctx=ctx, num_processes=mh.num_processes,
                    # the delta retrain's frozen blocks (local indices), set
                    # only when every rank agreed to freeze the coordinate
                    frozen_blocks=frozen_blocks.get(name))
            elif name in fe_coords:
                coords[name] = fe_coords[name].rebind(GLMOptimizationProblem(
                    p.task_type, cfg.optimizer, cfg.optimizer_config(),
                    cfg.regularization_context()))
            elif name in p.factored_configs:
                spec = p.factored_configs[name]
                coords[name] = PerHostFactoredRandomEffectCoordinate(
                    re_datasets[name], p.task_type,
                    mf_config=MFOptimizationConfig(spec.mf_num_iterations, spec.latent_dim),
                    re_optimizer=spec.random_effect.optimizer,
                    re_optimizer_config=spec.random_effect.optimizer_config(),
                    re_regularization=spec.random_effect.regularization_context(),
                    latent_optimizer=spec.latent_factor.optimizer,
                    latent_optimizer_config=spec.latent_factor.optimizer_config(),
                    latent_regularization=spec.latent_factor.regularization_context(),
                    ctx=ctx)
            else:
                sd = re_datasets[name]
                cls = (PerHostBucketedRandomEffectSolver if isinstance(sd, BucketedShardedREData)
                       else PerHostRandomEffectSolver)
                coords[name] = cls(sd, p.task_type, cfg.optimizer, cfg.optimizer_config(),
                                   cfg.regularization_context(), ctx, solve_label=name,
                                   bucketer=plan.bucketer)
        return coords

    # ---- validation data, decoded once ---------------------------------------
    val_data = None
    if p.validate_input_dirs:
        val_data = _decode_validation(p, mh, ctx, shard_maps, needed_shards, id_types)

    loss = losses_mod.for_task(p.task_type)

    def loss_fn(total_scores: Tensor) -> Tensor:
        return torch.sum(weights_g * loss.loss(total_scores + offsets_g, labels_g))

    specs = p.evaluators or _default_evaluators(p.task_type)
    primary = specs[0]
    primary_key = primary[0].value if primary[1] is None else f"{primary[0].value}@{primary[1]}"
    primary_ev = evaluator_for(primary[0], primary[1] or 10)

    best_index, best_value, best_result, best_coords = 0, None, None, None
    all_metrics: List[Dict[str, float]] = []
    prev_coefficients = None
    hb_dir = os.path.join(p.output_dir, "heartbeats")
    mh.write_heartbeat(hb_dir, step=None)
    if mh.coordinator_only_io():
        logger.info(mh.describe_heartbeats(hb_dir))
    for i, combo in enumerate(combos):
        coords = build_coords(combo)
        checkpointer = None
        if p.checkpoint_dir:
            from photon_ml_tpu_torch.checkpoint import CoordinateDescentCheckpointer, fingerprint
            from photon_ml_tpu_torch.checkpoint_async import maybe_async

            # per-host streaming state is each rank's own: every rank keeps
            # its own checkpoint dir, and the restore agrees on the step
            per_rank = bool(streaming_manifests)
            ck_dir = os.path.join(p.checkpoint_dir, f"combo-{i}")
            checkpointer = maybe_async(CoordinateDescentCheckpointer(
                os.path.join(ck_dir, f"process-{mh.process_id}") if per_rank else ck_dir,
                run_fingerprint=fingerprint({
                    "multihost": True,
                    "coordinates": p.updating_sequence,
                    "num_rows": n_global,
                    "combo": i,
                    "warm_start": mh_args["grid_warm_start"],
                    "configs": {k: str(v) for k, v in combo.items()},
                }),
                multihost=mh,
                sharded={n: c.rank_sharded_leaves for n, c in coords.items()
                         if hasattr(c, "rank_sharded_leaves")},
                per_rank=per_rank),
                p.checkpoint_async)
        cd = CoordinateDescent(coords, loss_fn)
        try:
            # combo 0 (every combo without --grid-warm-start) starts from
            # the delta retrain's warm start; later combos under
            # --grid-warm-start from the previous combo's coefficients
            result = cd.run(p.num_iterations, n_global, checkpointer,
                            initial_params=(prev_coefficients
                                            if mh_args["grid_warm_start"]
                                            and prev_coefficients is not None else warm_init),
                            frozen=frozen_names)
        finally:
            if checkpointer is not None and hasattr(checkpointer, "close"):
                checkpointer.close()
        prev_coefficients = result.coefficients
        mh.write_heartbeat(hb_dir, step=(i + 1) * p.num_iterations)
        if mh.coordinator_only_io():
            logger.info(mh.describe_heartbeats(hb_dir))
        logger.info(f"combo {i}: objective history "
                    + " ".join(f"{v:.6g}" for v in result.objective_history))
        for cname, tracker in result.trackers.items():
            summary = _summarize_tracker(tracker)
            if summary:
                logger.info(f"combo {i} [{cname}] (this process) {summary}")
        metrics: Dict[str, float] = {}
        if val_data is not None:
            metrics = _validate(p, mh, ctx, coords, result, val_data)
            logger.info(f"combo {i} validation: "
                        + " ".join(f"{k}={v:.6g}" for k, v in metrics.items()))
        all_metrics.append(metrics)
        if metrics and primary_key in metrics:
            value = metrics[primary_key]
            if best_value is None or primary_ev.better_than(value, best_value):
                best_value, best_index = value, i
                best_result, best_coords = result, coords
        elif best_result is None:
            best_result, best_coords = result, coords
    if len(combos) > 1:
        logger.info(f"best combo: {best_index}"
                    + (f" ({primary_key}={best_value:.6g})" if best_value is not None else ""))
    result, coords = best_result, best_coords

    # ---- save (reference layout; random-effect parts written per host) ------
    out = os.path.join(p.output_dir, "best")
    mh.barrier("pre-save")
    if mh.coordinator_only_io():
        os.makedirs(out, exist_ok=True)
    mh.barrier("outdir")
    for name in p.updating_sequence:
        w = result.coefficients[name]
        if name in p.fixed_effect_data_configs:
            if mh.coordinator_only_io():
                spec = p.fixed_effect_data_configs[name]
                model_io.save_fixed_effect(out, name, p.task_type, w.detach().cpu().numpy(),
                                           shard_maps[spec.feature_shard_id],
                                           feature_shard_id=spec.feature_shard_id)
        else:
            dc = p.random_effect_data_configs[name]
            save = (_save_factored_parts if name in p.factored_configs
                    else _save_streaming_re_parts if name in streaming_manifests
                    else _save_random_effect_parts)
            save(out, name, p, dc, coords[name], w, shard_maps[dc.feature_shard_id], mh)
        mh.barrier(f"saved-{name}")
    logger.info(f"model saved to {out}")
    if mh.coordinator_only_io():
        try:
            _write_mh_retrain_manifest(p, plan, out, shard_maps, combos, best_index,
                                       streaming_manifests, coord_cache_keys, train_file_stats,
                                       logger, coord_objs=coords)
        except (OSError, TypeError, ValueError) as e:
            # a failed manifest write degrades tomorrow's run to cold; it
            # must not fail today's finished training run
            logger.warn(f"retrain manifest write failed ({e}); the next run retrains cold")
    mh.barrier("retrain-manifest")
    logger.close()
    return {
        "objective_history": result.objective_history,
        "validation_metrics": all_metrics[best_index],
        "all_metrics": all_metrics,
        "best_index": best_index,
        "num_rows": n_global,
        "process_id": mh.process_id,
        "num_processes": mh.num_processes,
        "backend": ctx.backend,
        "device": str(ctx.device),
        "output": out,
        "coordinates": coords,
        "result": result,
        # each streaming coordinate's owned global block ids
        "streaming_blocks": {n: [int(g) for g in m.global_block_ids]
                             for n, m in streaming_manifests.items()},
        "delta_digest": delta_digest,
        # a delta retrain's frozen blocks on this rank, by global block id
        "frozen_blocks": {n: sorted(int(streaming_manifests[n].global_block_ids[i]) for i in fb)
                          for n, fb in frozen_blocks.items() if n in streaming_manifests},
        # rows this run's training decode put into each feature shard, and
        # each adopted coordinate's relaunch re-plan
        "decoded_shard_rows": decoded_shard_rows,
        "adopted": {n: {"plan_version": int(r.plan.version), "blocks": [int(g) for g in r.adopted],
                        "state_files": int(r.state_files_adopted),
                        "moved": [list(map(int, m)) for m in r.moved], "seconds": adoption_s}
                    for n, r in adopted.items()},
    }


def _mh_ingest_inputs(p, plan) -> Dict[str, object]:
    bk = plan.bucketer
    return {
        "sections": {k: list(v) for k, v in sorted((p.feature_shard_sections or {}).items())},
        "intercepts": {k: bool(v) for k, v in sorted(
            (p.feature_shard_intercepts or {}).items())},
        "id_types": sorted({c.random_effect_id for c in p.random_effect_data_configs.values()}),
        "ladder": bk.spec() if bk is not None else None,
        "offheap_indexmap_dir": p.offheap_indexmap_dir,
        "name_and_term": p.feature_name_and_term_set_path,
    }


def _mh_eval_identity(p) -> Dict[str, object]:
    """The validation side's identity (file stats and evaluator specs): a
    changed validation set re-scores even when training has nothing to do."""
    from photon_ml_tpu_torch.cli.game_training_driver import (
        _input_files,
        resolve_date_range_dirs,
    )
    from photon_ml_tpu_torch.io.tensor_cache import file_stat_token

    val_files = (_input_files(resolve_date_range_dirs(
        p.validate_input_dirs, p.validate_date_range, p.validate_date_range_days_ago))
        if p.validate_input_dirs else [])
    return {"validate_files": file_stat_token(val_files),
            "evaluators": [[etype.value, k, id_name]
                           for etype, k, id_name in (p.evaluators or [])]}


def _mh_ingest_digest(p, plan, shard_maps) -> str:
    """SHA-256 of the ingest identity with each shard's feature-map digest
    (the feature space a warm start needs)."""
    from photon_ml_tpu_torch.io.tensor_cache import index_map_digest

    cfg = dict(_mh_ingest_inputs(p, plan), index_maps={
        shard: index_map_digest(imap) for shard, imap in sorted(shard_maps.items())})
    return hashlib.sha256(json.dumps(cfg, sort_keys=True, default=str).encode()).hexdigest()


def _blocking_unchanged(prior, name, manifest) -> bool:
    """Whether the prior run's entity blocking is this run's (``block_of``
    is a function of the agreed counts alone, so the check holds across
    rank counts); False for a prior without plan sidecars."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import _PLAN_BLOCK_OF

    rec = prior.coordinates.get(name)
    if rec is None or not rec.streaming_manifest_dir:
        return False
    try:
        prior_bo = np.load(os.path.join(rec.streaming_manifest_dir, _PLAN_BLOCK_OF))
        cur_bo, _ = manifest.plan_arrays()
    except OSError:
        return False
    return bool(np.array_equal(np.asarray(prior_bo), np.asarray(cur_bo)))


def _prepare_multihost_warm(p, mh, ctx, logger, plan, shard_maps, all_files,
                            streaming_manifests, combos, pin_status=None):
    """``--warm-start-from``: every rank plans its own delta against the
    prior ``retrain.json`` and builds its warm seeds, and one collective
    compares a digest of the outcome (classification, warm and frozen sets)
    across the ranks. A disagreement, or any rank's unusable prior (an
    injected ``retrain.multihost_delta_agree`` fault included), makes every
    rank train cold, recorded; no rank is left waiting in a collective.

    A fixed effect warm-starts (and freezes when unchanged); a streaming
    random effect is seeded for the rank's owned blocks and freezes every
    owned block when the coordinate is unchanged and the prior blocking is
    this run's, or, when its inputs moved under the pinned prior blocking
    (``pin_status``) and its configuration did not, freezes the owned
    blocks whose entities and rows are the prior's; an in-memory random
    effect trains cold (its slabs are built by the shuffle, with no seeding
    path). Returns ``(initial params or None, frozen blocks by coordinate,
    frozen coordinate names, the agreed digest or None)``."""
    if not p.warm_start_from:
        return None, {}, set(), None
    from photon_ml_tpu_torch import retrain
    from photon_ml_tpu_torch.resilience import faults
    from photon_ml_tpu_torch.retrain.delta import NEW

    prior = delta = None
    warm: Dict[str, object] = {}
    frozen_blocks: Dict[str, frozenset] = {}
    frozen: set = set()
    canon, why = None, ""
    try:
        # the fault fires first and the vote runs after it, whatever
        # happens: a failure poisons this rank's digest, and the rank still
        # votes below
        faults.inject("retrain.multihost_delta_agree", process=int(mh.process_id))
        prior = retrain.load_prior_manifest(p.warm_start_from)
        combo_configs = None
        if len(combos) == 1:
            combo_configs = {name: str(combos[0].get(name, CoordinateOptConfig()))
                             for name in p.updating_sequence}
        delta = retrain.plan_delta(prior, all_files, task=p.task_type.value,
                                   updating_sequence=p.updating_sequence,
                                   ingest_inputs=_mh_ingest_inputs(p, plan),
                                   combo_configs=combo_configs,
                                   eval_identity=_mh_eval_identity(p))
        freezable = delta.frozen_coordinates() if len(combos) == 1 else set()
        for name in p.updating_sequence:
            cdelta = delta.coordinates.get(name)
            if cdelta is None or cdelta.status == NEW:
                continue
            if name in p.fixed_effect_data_configs:
                spec = p.fixed_effect_data_configs[name]
                w0 = retrain.fixed_effect_init(prior.model_dir, name,
                                               shard_maps[spec.feature_shard_id])
                if w0 is None:
                    logger.info(f"warm start {name}: prior fixed-effect model missing — cold")
                    continue
                warm[name] = torch.from_numpy(np.asarray(w0)).to(ctx.device)
                if name in freezable:
                    frozen.add(name)
            elif name in streaming_manifests:
                dc = p.random_effect_data_configs[name]
                means = retrain.random_effect_entity_means(prior.model_dir, name,
                                                           shard_maps[dc.feature_shard_id])
                if means is None:
                    logger.info(f"warm start {name}: prior random-effect model missing or "
                                "factored — cold")
                    continue
                warm[name] = retrain.seed_perhost_spilled_state(
                    streaming_manifests[name], means,
                    os.path.join(p.output_dir, "retrain-warm", f"{name}-host{mh.process_id}"))
                sm = streaming_manifests[name]
                if name in freezable and _blocking_unchanged(prior, name, sm):
                    frozen.add(name)
                    # every owned block skips its solve, bitwise the prior
                    frozen_blocks[name] = frozenset(range(len(sm.blocks)))
                elif (name in (pin_status or {}) and combo_configs is not None
                      and combo_configs[name] == prior.coordinates[name].opt_config):
                    # the pinned prior blocking's unchanged blocks, by
                    # their local index among this rank's blocks
                    status = pin_status[name]
                    frozen_blocks[name] = frozenset(
                        i for i, g in enumerate(sm.global_block_ids) if status[g] == "unchanged")
                    logger.info(f"delta retrain [{name}]: freezing "
                                f"{sum(s_ == 'unchanged' for s_ in status)}/{len(status)} "
                                f"unchanged blocks, {len(frozen_blocks[name])} on this host")
            else:
                logger.info(f"warm start {name}: no multihost warm path for this coordinate "
                            "kind — cold")
        canon = json.dumps({"status": {n: c.status for n, c in delta.coordinates.items()},
                            "warm": sorted(warm), "frozen": sorted(frozen),
                            "frozen_blocks": {n: sorted(g for g, st in enumerate(
                                (pin_status or {}).get(n, ())) if st == "unchanged")
                                for n in frozen_blocks}}, sort_keys=True)
    except Exception as e:  # noqa: BLE001 — any unusable prior (bad JSON, a vanished model, an unwritable seed dir, an injected fault) degrades to a cold run, never a wrong warm result or a stranded collective
        warm, frozen_blocks, frozen = {}, {}, set()
        canon, why = None, f"{type(e).__name__}: {e}"
    dmin = _agree_digest(canon, ctx, mh.num_processes)
    if dmin is None:
        logger.warn("--warm-start-from: delta plan disagrees across hosts or failed on at "
                    "least one host"
                    + (f" (here: {why})" if why else "")
                    + " — retraining cold everywhere (recorded decision)")
        return None, {}, set(), None
    logger.info(f"delta retrain plan (agreed across {mh.num_processes} hosts, digest {dmin}): "
                f"files {delta.files.describe()}; "
                + " ".join(f"{n}={c.status}" for n, c in delta.coordinates.items()))
    for line in delta.describe_decisions():
        logger.info(f"delta retrain: {line}")
    if warm:
        logger.info(f"warm start: {sorted(warm)} seeded from {prior.model_dir}"
                    + (f"; frozen {sorted(frozen)}" if frozen else ""))
    return (warm or None), frozen_blocks, frozen, dmin


def _write_mh_retrain_manifest(p, plan, best_dir, shard_maps, combos, best_index,
                               streaming_manifests, coord_cache_keys, train_file_stats, logger,
                               coord_objs=None) -> None:
    """The coordinator's ``retrain.json``: the next run's planner diffs
    against it. A streaming coordinate records the coordinator's manifest
    dir (its plan sidecars name the run's blocking) and its convergence
    ledger (the coordinator's own blocks, by global id)."""
    from photon_ml_tpu_torch.retrain.manifest import CoordinateRecord, RetrainManifest

    sel = combos[best_index]
    coords = {}
    for name in p.updating_sequence:
        kind = ("fixed" if name in p.fixed_effect_data_configs
                else "factored" if name in p.factored_configs
                else "streaming_random" if name in streaming_manifests
                else "bucketed" if p.bucketed_random_effects else "random")
        sm = streaming_manifests.get(name)
        export = getattr((coord_objs or {}).get(name), "ledger_export", None)
        coords[name] = CoordinateRecord(
            kind=kind, opt_config=str(sel.get(name, CoordinateOptConfig())),
            cache_key=coord_cache_keys.get(name),
            streaming_manifest_dir=os.path.abspath(sm.dir) if sm is not None else None,
            shard_plan_version=int(getattr(sm, "plan_version", 1)) if sm is not None else 1,
            convergence_ledger=(export() or None) if callable(export) else None)
    manifest = RetrainManifest(
        output_dir=os.path.abspath(p.output_dir), model_dir=os.path.abspath(best_dir),
        task=p.task_type.value, file_stats=train_file_stats,
        ingest_inputs=_mh_ingest_inputs(p, plan),
        ingest_digest=_mh_ingest_digest(p, plan, shard_maps),
        updating_sequence=list(p.updating_sequence), coordinates=coords, data_cache_key=None,
        eval_identity=_mh_eval_identity(p))
    logger.info(f"retrain manifest written: {manifest.save(p.output_dir)}")


def _re_dir(out, name, dc, mh, id_info: str) -> str:
    """The coordinator makes a random effect's dirs and id-info; the other
    processes wait for it."""
    base = os.path.join(out, model_io.RANDOM_EFFECT, name)
    if mh.coordinator_only_io():
        os.makedirs(os.path.join(base, model_io.COEFFICIENTS), exist_ok=True)
        with open(os.path.join(base, model_io.ID_INFO), "w") as f:
            f.write(id_info)
    mh.barrier(f"re-dir-{name}")
    return base


def _save_random_effect_parts(out, name, p, dc, coord, w, imap, mh) -> None:
    """Each process writes ONE part file with its entities (the coefficient
    blocks never cross processes, ModelProcessingUtils.scala:205-219); raw
    ids rode the exchange (``raw_ids_by_key``)."""
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import schemas

    sd = coord.data
    base = _re_dir(out, name, dc, mh, f"{dc.random_effect_id}\n{dc.feature_shard_id}\n")
    if isinstance(sd, BucketedShardedREData):
        groups = [(wb, b.entity_keys, b.entity_mask, b.local_to_global)
                  for b, wb in zip(sd.buckets, w)]
    else:
        groups = [(w, sd.entity_keys, sd.entity_mask, sd.local_to_global)]
    pm = sd.projection_matrix
    host = lambda t: t.detach().cpu().numpy()
    records = []
    for warr, karr, marr, larr in groups:
        wh, kh, lh = host(warr), host(karr), host(larr)
        keys = _unpack_u64(kh[:, 0], kh[:, 1])
        for lane in np.nonzero(host(marr))[0]:
            raw = sd.raw_ids_by_key[int(keys[lane])]
            if pm is not None:
                # RANDOM: back-project through the shared matrix
                dense = np.asarray(pm).T @ np.asarray(wh[lane], np.float32)
            else:
                dense = np.zeros(sd.global_dim, np.float32)
                valid = lh[lane] >= 0
                dense[lh[lane][valid]] = wh[lane][valid]
            records.append(model_io._model_record(raw, p.task_type, dense, None, imap))
    avro_io.write_container(
        os.path.join(base, model_io.COEFFICIENTS, f"part-{mh.process_id:05d}.avro"), records,
        schemas.BAYESIAN_LINEAR_MODEL)


def _save_streaming_re_parts(out, name, p, dc, coord, state, imap, mh) -> None:
    """A per-host streaming random effect: each process writes ONE part file
    with the entities of the blocks it owns (the spilled state never
    crosses processes; the means come from block bookkeeping alone)."""
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import schemas

    base = _re_dir(out, name, dc, mh, f"{dc.random_effect_id}\n{dc.feature_shard_id}\n")
    means = coord.entity_means_by_raw_id(state)
    records = [model_io._model_record(raw, p.task_type, np.asarray(vec, np.float32), None, imap)
               for raw, vec in sorted(means.items())]
    avro_io.write_container(
        os.path.join(base, model_io.COEFFICIENTS, f"part-{mh.process_id:05d}.avro"), records,
        schemas.BAYESIAN_LINEAR_MODEL)


def _save_factored_parts(out, name, p, dc, coord, state, imap, mh) -> None:
    """A factored random effect: each process writes ITS entities' W = V M
    part and latent-factor part; the coordinator writes the shared latent
    matrix, its column keys and the factored id-info marker."""
    from photon_ml_tpu_torch.io import avro as avro_io
    from photon_ml_tpu_torch.io import schemas

    base = os.path.join(out, model_io.RANDOM_EFFECT, name)
    matrix = state.matrix.detach().cpu().numpy().astype(np.float32)
    if mh.coordinator_only_io():
        os.makedirs(os.path.join(base, model_io.LATENT_FACTORS), exist_ok=True)
        model_io.save_latent_factors(os.path.join(base, model_io.LATENT_MATRIX),
                                     {str(k): matrix[k] for k in range(matrix.shape[0])})
    mh.barrier(f"fre-dir-{name}")
    _save_random_effect_parts(out, name, p, dc, coord, coord.random_effect_coefficients(state),
                              imap, mh)
    # the factored marker last: the plain writer wrote the 2-line id-info
    if mh.coordinator_only_io():
        with open(os.path.join(base, model_io.ID_INFO), "w") as f:
            f.write(f"{dc.random_effect_id}\n{dc.feature_shard_id}\nfactored\n")
        pairs = [list(model_io._split_key(imap.get_feature_name(j) or str(j)))
                 for j in range(matrix.shape[1])]
        with open(os.path.join(base, model_io.LATENT_MATRIX_FEATURES), "w") as f:
            json.dump({"columns": pairs}, f)
    recs = [{"effectId": str(eid), "latentFactor": [float(v) for v in vec]}
            for eid, vec in sorted(coord.latent_factors_by_raw_id(state).items())]
    avro_io.write_container(
        os.path.join(base, model_io.LATENT_FACTORS, f"part-{mh.process_id:05d}.avro"), recs,
        schemas.LATENT_FACTOR)


def _decode_validation(p, mh, ctx, shard_maps, needed_shards, id_types) -> dict:
    """This host's share of the validation files and the merged replicated
    label / weight / offset vectors, decoded once per run."""
    from photon_ml_tpu_torch.cli.game_training_driver import (
        _default_evaluators,
        _input_files,
        resolve_date_range_dirs,
    )

    specs = p.evaluators or _default_evaluators(p.task_type)
    grouped_ids = sorted({idn for _, _, idn in specs if idn is not None})
    id_types = sorted(set(id_types) | set(grouped_ids))
    val_files = _input_files(resolve_date_range_dirs(
        p.validate_input_dirs, p.validate_date_range, p.validate_date_range_days_ago))
    vgds = _decode_share(p, host_file_share(val_files, mh.num_processes, mh.process_id),
                         shard_maps, needed_shards, id_types)
    file_base, nv = global_row_layout(len(val_files), vgds, ctx, mh.num_processes)

    def merge(vec_per_gd):
        return merge_row_vectors(vgds, file_base, nv, ctx, mh.num_processes, vec_per_gd)

    return {"specs": specs, "grouped_ids": grouped_ids, "vgds": vgds, "file_base": file_base,
            "nv": nv, "labels": merge(lambda gd: gd.response.astype(np.float32)),
            "weights": merge(lambda gd: gd.weight.astype(np.float32)),
            "offsets": merge(lambda gd: gd.offset.astype(np.float32))}


def _validate(p, mh, ctx, coords, result, val_data) -> Dict[str, float]:
    """Validation metrics: each host scores only its share of the rows;
    the fixed effect locally (its model is replicated), random effects by
    routing each row to its entity's owner (score_routed_rows; factored
    coordinates against W = V M). Scores merge with one collective sum, so
    every host computes the same metrics."""
    from photon_ml_tpu_torch.evaluation.evaluators import evaluator_for
    from photon_ml_tpu_torch.parallel.perhost_factored import (
        PerHostFactoredRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.parallel.perhost_ingest import score_routed_rows
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        PerHostStreamingRandomEffectCoordinate,
        score_routed_rows_streaming,
    )

    vgds, file_base, nv = val_data["vgds"], val_data["file_base"], val_data["nv"]
    scores = val_data["offsets"].astype(np.float64).copy()
    for name in p.updating_sequence:
        coord, w = coords[name], result.coefficients[name]
        if name in p.fixed_effect_data_configs:
            spec = p.fixed_effect_data_configs[name]
            w_host = w.detach().cpu().numpy()
            local = np.zeros(nv, np.float32)
            for ordinal, gd in vgds:
                fi, fv = csr_to_padded(gd.shards[spec.feature_shard_id], gd.num_rows)
                sel = np.where(fi >= 0, w_host[np.maximum(fi, 0)], 0.0)
                local[file_base[ordinal] + np.arange(gd.num_rows)] = np.sum(sel * fv, axis=1)
            scores += collective_sum(local, ctx, mh.num_processes)
            continue
        dc = p.random_effect_data_configs[name]
        if isinstance(coord, PerHostStreamingRandomEffectCoordinate):
            # rows go to their block's owner, which dots them with its means
            vrows = _host_rows(vgds, file_base, dc.feature_shard_id, dc.random_effect_id,
                               coord.manifest.global_dim)
            scores += score_routed_rows_streaming(coord.manifest, coord.entity_means_by_raw_id(w),
                                                  vrows, nv, ctx, mh.num_processes,
                                                  mh.process_id)
            continue
        vrows = _host_rows(vgds, file_base, dc.feature_shard_id, dc.random_effect_id,
                           coord.data.global_dim)
        if isinstance(coord, PerHostFactoredRandomEffectCoordinate):
            w = coord.random_effect_coefficients(w)
        scores += score_routed_rows(coord.data, w, vrows, nv, ctx, mh.num_processes,
                                    mh.process_id)
    s = torch.from_numpy(scores.astype(np.float32))
    group_cols = {idn: torch.from_numpy(merge_group_ids(vgds, file_base, nv, idn, ctx,
                                                        mh.num_processes))
                  for idn in val_data["grouped_ids"]}
    metrics: Dict[str, float] = {}
    for etype, k, id_name in val_data["specs"]:
        ev = evaluator_for(etype, k or 10)
        kwargs = {"labels": torch.from_numpy(val_data["labels"]),
                  "weights": torch.from_numpy(val_data["weights"])}
        if id_name is not None:
            kwargs["group_ids"] = group_cols[id_name]
        metrics[etype.value if k is None else f"{etype.value}@{k}"] = float(
            ev.evaluate(s, **kwargs))
    return metrics


if __name__ == "__main__":
    main()
