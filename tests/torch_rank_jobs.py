"""Jobs the multi-rank port tests run on every rank (tests/torch_ranks.py):
each takes the rank's ``MultihostContext`` and a picklable payload and
returns picklable numpy results. Imports torch and the port only."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def _rows_of(payload, rank: int):
    from photon_ml_tpu_torch.parallel.perhost_ingest import HostRows

    sel = payload["owner_rank"] == rank
    return HostRows(
        entity_raw_ids=[r for r, s in zip(payload["raw_ids"], sel) if s],
        row_index=payload["row_index"][sel], labels=payload["labels"][sel],
        weights=payload["weights"][sel], offsets=payload["offsets"][sel],
        feat_idx=payload["feat_idx"][sel], feat_val=payload["feat_val"][sel],
        global_dim=payload["global_dim"])


def collectives(mh, payload):
    """Every collective of the mesh on rank-dependent inputs."""
    ctx = mh.mesh_context()
    r = ctx.rank
    f = torch.tensor([0.1 * (r + 1), 1e8, -3.0 * r], dtype=torch.float32)
    i = torch.tensor([r, 5 - r, 7 * r], dtype=torch.int64)
    send = torch.arange(ctx.world * 2 * 3, dtype=torch.int32).reshape(ctx.world, 2, 3) + 100 * r
    return {"sum": _np(ctx.sum(f)), "max": _np(ctx.max(i)), "min": _np(ctx.min(i)),
            "concat": _np(ctx.concat(i)), "a2a": _np(ctx.all_to_all(send)),
            "steps": [mh.agree_restore_step(s) for s in ([3, 5][r], None if r else 4)]}


def exchange(mh, payload):
    """exchange_rows of this rank's share of the rows to their owners."""
    from photon_ml_tpu_torch.parallel import shuffle

    ctx = mh.mesh_context()
    rows = _rows_of(payload, ctx.rank)
    keys = shuffle.stable_entity_keys(rows.entity_raw_ids)
    b = shuffle.bucket_of(keys, payload["num_buckets"])
    counts = np.bincount(b, minlength=payload["num_buckets"]).astype(np.int64)
    owners = shuffle.balanced_bucket_owners(
        shuffle.collective_sum(counts, ctx, mh.num_processes), ctx.num_devices)
    ints = np.concatenate([rows.row_index.astype(np.int32)[:, None], rows.feat_idx], axis=1)
    ex = shuffle.exchange_rows(owners[b], ints, rows.feat_val, ctx, mh.num_processes,
                               mh.process_id)
    return {"owners": owners, "ints": ex.int_rows[0], "floats": ex.float_rows[0]}


def ingest(mh, payload):
    """per_host_re_dataset of this rank's rows under each build of
    ``payload["builds"]``: every field of the block, and the exchange."""
    from photon_ml_tpu_torch.parallel.perhost_ingest import per_host_re_dataset

    rows = _rows_of(payload, mh.process_id)
    outs = {"exchange": exchange(mh, payload)}
    for name, kw in payload["builds"].items():
        sd = per_host_re_dataset(rows, mh.mesh_context(), mh.num_processes, mh.process_id, **kw)
        out = {"meta": {k: getattr(sd, k) for k in (
            "num_entities", "entities_per_device", "rows_per_device", "num_rows", "global_dim",
            "row_ids_dense")}, "owners": sd.bucket_owners, "raw_ids": sd.raw_ids_by_key}
        if hasattr(sd, "buckets"):
            out["buckets"] = [{f.name: _np(getattr(b, f.name)) for f in dataclasses.fields(b)}
                              for b in sd.buckets]
        else:
            out["buckets"] = [{f: _np(getattr(sd, f)) for f in (
                "row_index", "x", "labels", "base_offsets", "weights", "local_to_global",
                "entity_keys", "entity_mask")}]
        for f in ("score_row_index", "score_slot", "score_feat_idx", "score_feat_val"):
            out[f] = _np(getattr(sd, f))
        outs[name] = out
    return outs


def _problem(spec):
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.common import OptimizerConfig
    from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    return GLMOptimizationProblem(
        TaskType.LOGISTIC_REGRESSION, OptimizerType[spec["optimizer"]],
        OptimizerConfig(max_iterations=spec["iters"], tolerance=spec["tol"]),
        RegularizationContext.l2(spec["lambda"]))


def fixed_effect_solves(mh, payload):
    """The distributed fixed-effect solve on this rank's contiguous block
    of the rows; every rank returns the whole (replicated) coefficients."""
    from photon_ml_tpu_torch.ops.features import DenseFeatures
    from photon_ml_tpu_torch.ops.normalization import NormalizationContext
    from photon_ml_tpu_torch.ops.objective import GLMBatch
    from photon_ml_tpu_torch.parallel.distributed import DistributedFixedEffectSolver

    ctx = mh.mesh_context()
    fe = payload["fe"]
    n = fe["x"].shape[0]
    lo, hi = ctx.block(n)
    lo, hi = min(lo, n), min(hi, n)
    t = lambda a: torch.from_numpy(a[lo:hi])
    batch = GLMBatch(DenseFeatures(t(fe["x"])), t(fe["y"]), t(fe["off"]), t(fe["w"]))
    out = {}
    for spec in payload["fe_problems"]:
        model, _ = DistributedFixedEffectSolver(_problem(spec), ctx).run(
            batch, NormalizationContext.identity())
        out[f"fe-{spec['optimizer']}"] = _np(model.coefficients.means)
    return out


def perhost_solves(mh, payload):
    """per_host_re_dataset, the per-host solver's update and owner-computed
    score, routed scoring of every rank's rows, the model blocks of
    per_host_model_slabs, and the row-layout helpers."""
    from photon_ml_tpu_torch.parallel import perhost_ingest as pi
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    ctx = mh.mesh_context()
    rows = _rows_of(payload, mh.process_id)
    out = {}
    for kw_name, kw in payload["builds"].items():
        sd = pi.per_host_re_dataset(rows, ctx, mh.num_processes, mh.process_id, **kw)
        p = _problem(payload["problem"])
        cls = pi.PerHostBucketedRandomEffectSolver if hasattr(sd, "buckets") else \
            pi.PerHostRandomEffectSolver
        solver = cls(sd, TaskType.LOGISTIC_REGRESSION, OptimizerType.LBFGS,
                     p.optimizer_config, p.regularization, ctx, sparse_kernel=payload["sparse"])
        resid = torch.from_numpy(payload["resid"])
        w, _ = solver.update(resid, solver.initial_coefficients())
        routed = pi.score_routed_rows(sd, w, rows, len(payload["raw_ids"]), ctx,
                                      mh.num_processes, mh.process_id)
        out[kw_name] = {"w": [_np(x) for x in w] if isinstance(w, tuple) else [_np(w)],
                        "score": _np(solver.score(w)), "routed": routed,
                        "reg": float(solver.regularization_term(w))}
    m = payload["model"]
    sel = np.arange(len(m["ids"])) % mh.num_processes == mh.process_id
    sd, w = pi.per_host_model_slabs([i for i, s in zip(m["ids"], sel) if s], m["idx"][sel],
                                    m["val"][sel], m["dim"], ctx, mh.num_processes,
                                    mh.process_id, num_buckets=payload["num_buckets"])
    out["model_slabs"] = (_np(w), _np(sd.entity_keys), _np(sd.local_to_global))
    strided = dataclasses.replace(rows, row_index=payload["strided"][
        payload["owner_rank"] == mh.process_id])
    out["densified"] = pi.densify_row_ids(strided, payload["stride"], ctx,
                                          mh.num_processes).row_index
    return out


def dead_peer(mh, payload):
    """Rank 1 leaves at once; rank 0's collectives must then raise."""
    import time

    from photon_ml_tpu_torch.parallel import shuffle
    from photon_ml_tpu_torch.parallel.mesh import CollectiveError

    if mh.process_id == 1:
        return None
    time.sleep(1.0)
    ctx = mh.mesh_context()
    raised = []
    for call in (lambda: ctx.sum(torch.ones(2)),
                 lambda: shuffle.collective_sum(np.ones(3, np.int64), ctx, mh.num_processes)):
        try:
            call()
            raised.append(None)
        except CollectiveError as e:
            raised.append(str(e))
    return raised


def card_shuffle(mh, payload):
    """The integer shuffle of this rank's rows, then every rank's received
    records gathered from a tensor on the rank's device (through the host
    under gloo): the backend, and the records in record-id order."""
    ctx = mh.mesh_context()
    got = exchange(mh, payload)["ints"]
    rows = torch.from_numpy(got).to(ctx.device)
    most = int(ctx.max(torch.tensor([rows.shape[0]], device=ctx.device)).item())
    pad = torch.full((most - rows.shape[0], rows.shape[1]), -1, dtype=rows.dtype,
                     device=ctx.device)
    every = ctx.concat(torch.cat([rows, pad]))
    every = every[every[:, 0] >= 0].cpu().numpy()
    return {"backend": ctx.backend, "device": str(ctx.device),
            "records": every[np.argsort(every[:, 0], kind="stable")]}


def perhost_factored(mh, payload):
    """The per-host factored coordinate on IDENTITY blocks: one update, its
    owner-computed score, regularization term and W = V M block."""
    from photon_ml_tpu_torch.algorithm.factored_random_effect import MFOptimizationConfig
    from photon_ml_tpu_torch.parallel.perhost_factored import (
        PerHostFactoredRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.parallel.perhost_ingest import per_host_re_dataset
    from photon_ml_tpu_torch.types import TaskType

    ctx = mh.mesh_context()
    sd = per_host_re_dataset(_rows_of(payload, mh.process_id), ctx, mh.num_processes,
                             mh.process_id, projector="IDENTITY",
                             num_buckets=payload["num_buckets"])
    p = _problem(payload["problem"])
    coord = PerHostFactoredRandomEffectCoordinate(
        sd, TaskType.LOGISTIC_REGRESSION, mf_config=MFOptimizationConfig(2, 2),
        re_optimizer=p.optimizer, re_optimizer_config=p.optimizer_config,
        re_regularization=p.regularization, latent_optimizer=p.optimizer,
        latent_optimizer_config=p.optimizer_config, latent_regularization=p.regularization,
        ctx=ctx)
    state, _ = coord.update(torch.from_numpy(payload["resid"]), coord.initial_coefficients())
    return {"v": _np(state.v), "matrix": _np(state.matrix), "score": _np(coord.score(state)),
            "reg": float(coord.regularization_term(state)),
            "w": _np(coord.random_effect_coefficients(state)),
            "factors": coord.latent_factors_by_raw_id(state)}


def _streaming_inputs(data, payload):
    """The dense fixed-effect rows and the global chunk sizes, shared by the
    rank job and the single-host reference."""
    n = data.num_rows
    gf = data.shards["global"]
    x_fe = np.zeros((n, gf.dim), np.float32)
    x_fe[np.repeat(np.arange(n), np.diff(gf.indptr)), gf.indices] = gf.values
    rows = payload["chunk_rows"]
    sizes = [min(rows, n - c * rows) for c in range(-(-n // rows))]
    return x_fe, sizes


def streaming_coordinates(data, payload, ctx=None, num_processes=1, process_id=0,
                          outdir=None, single_host=False, plan=None, membership=None,
                          elastic=None):
    """The descent's two coordinates: the per-host streaming pair on this
    rank's rows and chunks, or (``single_host``) the single-host streaming
    pair on every row and chunk. ``membership`` and ``elastic`` (a
    ``parallel.elastic`` membership and monitor) go to the per-host pair.
    Imports the port only."""
    from photon_ml_tpu_torch.algorithm.streaming_fixed_effect import (
        PerHostStreamingFixedEffectCoordinate,
        StreamingFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.algorithm.streaming_random_effect import (
        StreamingRandomEffectCoordinate,
        write_re_entity_blocks,
    )
    from photon_ml_tpu_torch.data.game import RandomEffectDataConfig
    from photon_ml_tpu_torch.optim.streaming import ChunkedGLMSource
    from photon_ml_tpu_torch.parallel.perhost_ingest import HostRows, csr_to_padded
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        PerHostStreamingRandomEffectCoordinate,
        build_perhost_streaming_manifest,
    )
    from photon_ml_tpu_torch.types import OptimizerType, TaskType

    import os

    cfg = RandomEffectDataConfig("userId", "per_user")
    x_fe, sizes = _streaming_inputs(data, payload)
    n = data.num_rows
    fe_problem = _problem(payload["fe"])
    re_problem = _problem(payload["re"])
    re_kw = dict(task=TaskType.LOGISTIC_REGRESSION, optimizer=OptimizerType.LBFGS,
                 optimizer_config=re_problem.optimizer_config,
                 regularization=re_problem.regularization, plan=plan, device="cpu")
    y = data.response.astype(np.float32)
    if single_host:
        man = write_re_entity_blocks(data, cfg, os.path.join(outdir, "ref-blocks"),
                                     block_entities=payload["block_entities"])
        re = StreamingRandomEffectCoordinate(manifest=man,
                                             state_root=os.path.join(outdir, "ref-state"), **re_kw)
        fe = StreamingFixedEffectCoordinate(
            ChunkedGLMSource.from_arrays(x_fe, y, payload["chunk_rows"]), fe_problem, plan=plan,
            device="cpu")
        return fe, re
    # this rank "decodes" its contiguous block of the rows
    lo = process_id * (n // num_processes)
    hi = n if process_id == num_processes - 1 else (process_id + 1) * (n // num_processes)
    fi, fv = csr_to_padded(data.shards["per_user"], n)
    vocab = data.id_vocabs["userId"]
    rows = HostRows(entity_raw_ids=[vocab[i] for i in data.ids["userId"][lo:hi]],
                    row_index=np.arange(lo, hi, dtype=np.int64), labels=y[lo:hi],
                    weights=data.weight[lo:hi].astype(np.float32),
                    offsets=data.offset[lo:hi].astype(np.float32), feat_idx=fi[lo:hi],
                    feat_val=fv[lo:hi], global_dim=data.shards["per_user"].dim)
    man = build_perhost_streaming_manifest(
        rows, cfg, os.path.join(outdir, f"re-host{process_id}"), ctx, num_processes,
        process_id, block_entities=payload["block_entities"],
        bucketer=plan.bucketer if plan is not None else None, membership=membership)
    re = PerHostStreamingRandomEffectCoordinate(
        manifest=man, state_root=os.path.join(outdir, f"re-state-host{process_id}"), ctx=ctx,
        num_processes=num_processes, elastic=elastic, **re_kw)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    owned = {}
    for c in range(len(sizes)):
        if c % num_processes == process_id:  # round-robin chunk ownership
            owned[c] = (lambda s=int(starts[c]), e=int(starts[c + 1]):
                        {"x": x_fe[s:e], "y": y[s:e]})
    fe = PerHostStreamingFixedEffectCoordinate(sizes, owned, x_fe.shape[1], fe_problem,
                                               ctx=ctx, num_processes=num_processes, plan=plan,
                                               device="cpu", elastic=elastic)
    return fe, re


def streaming_descent(coords, data, num_iterations=2):
    from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.ops import losses

    labels = torch.from_numpy(data.response.astype(np.float32))
    weights = torch.from_numpy(data.weight.astype(np.float32))
    fe, re = coords
    cd = CoordinateDescent({"fixed": fe, "per-user": re},
                           lambda s: torch.sum(weights * losses.logistic.loss(s, labels)))
    return cd.run(num_iterations, data.num_rows)


def perhost_streaming_cd(mh, payload):
    """Agree, plan, route, build the owned blocks, then the streaming
    descent over both coordinates on this rank's share, under the plan of
    ``payload["plan"]`` (the execution-plan flags) and the sparse race
    decisions of ``payload["race_decisions"]``. Returns the fixed
    effect, the total scores, the objectives, this rank's entity means and
    owned block ids, and the compacted solves' chunk count."""
    from photon_ml_tpu_torch.compile.plan import ExecutionPlan
    from photon_ml_tpu_torch.ops import fused_sparse
    from photon_ml_tpu_torch.optim.scheduler import solve_stats

    # the reference's race winners: the ranks race nothing and select as it did
    fused_sparse.adopt_race_decisions(payload.get("race_decisions") or [])
    ctx = mh.mesh_context()
    plan = ExecutionPlan.resolve(distributed=mh.num_processes > 1, streaming=True,
                                 num_processes=mh.num_processes, **payload.get("plan", {}))
    fe, re = streaming_coordinates(payload["data"], payload, ctx, mh.num_processes,
                                   mh.process_id, payload["outdir"], plan=plan)
    res = streaming_descent((fe, re), payload["data"])
    means = re.entity_means_by_raw_id(res.coefficients["per-user"])
    return {"fe": _np(res.coefficients["fixed"]), "total": _np(res.total_scores),
            "objectives": list(res.objective_history), "means": means,
            "owned": list(re.manifest.global_block_ids),
            "blocks_total": re.manifest.num_blocks_total,
            "reg": float(re.regularization_term(res.coefficients["per-user"])),
            "chunk_dispatches": solve_stats.totals()["chunk_dispatches"]}


def merge_signed_zero(mh, payload):
    """merge_disjoint of a score vector whose rank-owned entries include a
    -0.0: each rank writes its own rows into a -0.0 buffer."""
    from photon_ml_tpu_torch.parallel.perhost_streaming import disjoint_fill, merge_disjoint

    ctx = mh.mesh_context()
    full = torch.from_numpy(payload["scores"])
    owner = payload["owner"] % mh.num_processes
    local = disjoint_fill(full.shape, full.dtype)
    mine = torch.from_numpy(owner == mh.process_id)
    local[mine] = full[mine]
    terms = np.where(owner == mh.process_id, payload["scores"].astype(np.float64), -0.0)
    return {"merged": _np(merge_disjoint(local, ctx, mh.num_processes)),
            "merged64": merge_disjoint(terms, ctx, mh.num_processes)}


def lose_a_rank_mid_block(mh, payload):
    """Rank 1 dies hard after its first block spill inside the update; the
    survivor's post-update barrier must fail with a diagnosis."""
    import os

    from photon_ml_tpu_torch.algorithm import streaming_random_effect as sre
    from photon_ml_tpu_torch.parallel import multihost

    ctx = mh.mesh_context()
    _, re = streaming_coordinates(payload["data"], payload, ctx, mh.num_processes,
                                  mh.process_id, payload["outdir"])
    if mh.process_id == 1:
        write = sre.SpilledREState.write

        def dying_write(self, i, arr):
            write(self, i, arr)
            print("LOSTHOST-DYING", flush=True)
            os._exit(17)

        sre.SpilledREState.write = dying_write
    hb = os.path.join(payload["outdir"], "heartbeats")
    mh.write_heartbeat(hb, step=0)
    re.update(torch.zeros(payload["data"].num_rows), re.initial_coefficients())
    from photon_ml_tpu_torch.parallel.mesh import CollectiveError

    try:
        mh.barrier("post-update")
    except (multihost.BarrierTimeoutError, CollectiveError) as e:
        # our deadline, or the backend seeing the dead peer first: both name
        # the failure; neither hangs
        return {"error": f"{type(e).__name__}: {e}", "heartbeats": mh.describe_heartbeats(hb)}
    return {"error": None}


def elastic_streaming_cd(mh, payload):
    """tests/elastic_reshard_worker.py in the port: the per-host streaming
    descent under an elastic monitor, with a membership change mid-run.

    ``mode="loss"``: three logical owners on two ranks (owner 2 on rank 0);
    when rank 0 reaches its first block of epoch 2, owner 2 stops beating
    and is declared lost. ``mode="scaleup"``: two owners, and at the same
    point an operator request adds owner 2 on rank 1. Each rank fires the
    change itself (rank 1 at its epoch-2 update entry), drains at its next
    safe boundary (``ReplanRequired``, the emergency checkpoint), agrees
    plan v2 through the session, moves only the changed blocks and
    resumes on a coordinate rebuilt over the re-based manifest."""
    import os

    from photon_ml_tpu_torch.algorithm.coordinate_descent import CoordinateDescent
    from photon_ml_tpu_torch.checkpoint import CoordinateDescentCheckpointer
    from photon_ml_tpu_torch.compile.plan import ExecutionPlan
    from photon_ml_tpu_torch.ops import losses
    from photon_ml_tpu_torch.parallel.elastic import (
        ElasticMonitor,
        ElasticSession,
        FleetMembership,
        ReplanBarrierError,
        ReplanRequired,
        declare_lost_hosts,
        request_scale_up,
    )
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        PerHostStreamingRandomEffectCoordinate,
    )

    ctx = mh.mesh_context()
    pid, n = mh.process_id, mh.num_processes
    data, outdir, mode = payload["data"], payload["outdir"], payload["mode"]
    membership = (FleetMembership(1, [0, 1, 2], {0: 0, 1: 1, 2: 0}) if mode == "loss"
                  else FleetMembership.initial(n))
    fleet_dir = os.path.join(outdir, "fleet")
    monitor = ElasticMonitor(fleet_dir, membership, process_id=pid, heartbeat_deadline=15.0,
                             min_poll_interval=0.0, num_processes=n)
    session = ElasticSession(fleet_dir, pid, n, monitor, barrier_timeout=90.0)
    plan = ExecutionPlan.resolve(distributed=n > 1, streaming=True, num_processes=n,
                                 **payload.get("plan", {}))
    fe, re = streaming_coordinates(data, payload, ctx, n, pid, outdir, plan=plan,
                                   membership=membership, elastic=monitor)
    log = []
    fired = {"done": False}

    def fire():
        if mode == "loss":
            monitor.silence_host(2)
            declare_lost_hosts(fleet_dir, [2], reason="logical owner reclaimed")
        else:
            request_scale_up(fleet_dir, {2: 1}, reason="capacity arrived")
        log.append("TRIGGERED")

    if pid == 0:
        slab_for, calls = re._slab_for, {"n": 0}
        first_of_epoch2 = len(re.manifest.blocks) + 1

        def hooked(i, ds, extra):
            calls["n"] += 1
            if not fired["done"] and calls["n"] == first_of_epoch2:
                fired["done"] = True
                fire()
            return slab_for(i, ds, extra)

        re._slab_for = hooked
    else:
        update = re.update

        def entry_trigger(resid, state, resume=None):
            if not fired["done"] and re._epoch >= 1 and resume is None:
                fired["done"] = True
                fire()
            return update(resid, state, resume=resume)

        re.update = entry_trigger

    labels = torch.from_numpy(data.response.astype(np.float32))
    weights = torch.from_numpy(data.weight.astype(np.float32))
    ck = CoordinateDescentCheckpointer(os.path.join(outdir, f"ckpt-host{pid}"),
                                       run_fingerprint="elastic-harness")
    re_kw = dict(task=re.task, optimizer=re.optimizer, optimizer_config=re.optimizer_config,
                 regularization=re.regularization, plan=plan, device="cpu",
                 state_root=re.state_root, ctx=ctx, num_processes=n, elastic=monitor)
    replans, result = [], None
    while result is None:
        cd = CoordinateDescent({"fixed": fe, "per-user": re},
                               lambda s: torch.sum(weights * losses.logistic.loss(s, labels)))
        try:
            result = cd.run(2, data.num_rows, checkpointer=ck)
        except ReplanRequired as e:
            log.append(f"DRAINED v{e.proposal['version']} partial={e.partial is not None}")
            old_epoch = re._epoch
            try:
                res = session.replan(re.manifest, e.proposal, state_dir=re.replan_state_dirs(),
                                     epoch=old_epoch)
            except ReplanBarrierError as err:
                log.append(f"supervised-relaunch fallback: {err}")
                raise
            replans.append({"version": res.plan_version, "moved": res.moved,
                            "incoming": res.incoming, "rebuilt": res.rebuilt,
                            "blocks_total": res.blocks_total, "decisions": res.decisions})
            # the coordinate rebuilt on the re-based manifest, its epochs
            # above the interrupted numbering; the restore resumes mid-epoch
            re = PerHostStreamingRandomEffectCoordinate(manifest=res.manifest,
                                                        initial_epoch=old_epoch + 1, **re_kw)
    mh.barrier("cd-done")
    return {"fe": _np(result.coefficients["fixed"]), "total": _np(result.total_scores),
            "objectives": list(result.objective_history),
            "means": re.entity_means_by_raw_id(result.coefficients["per-user"]),
            "owned": list(re.manifest.global_block_ids), "replans": replans, "log": log,
            "plan_version": monitor.membership.version}


def pinned_perhost_build(mh, payload):
    """The per-host streaming build of ``payload["data"]`` (each rank its
    contiguous block of the rows) under the prior blocking pinned by
    ``pin_prior_blocking``: the committed plan's blocks, the statuses after
    any re-block, and this rank's block files' arrays by global id."""
    import os

    from photon_ml_tpu_torch.data.game import RandomEffectDataConfig
    from photon_ml_tpu_torch.parallel.perhost_ingest import HostRows, csr_to_padded
    from photon_ml_tpu_torch.parallel.perhost_streaming import (
        EntityShardPlan,
        build_perhost_streaming_manifest,
        pin_prior_blocking,
    )

    data, n, pid = payload["data"], mh.num_processes, mh.process_id
    rows_n = data.num_rows
    lo, hi = pid * (rows_n // n), rows_n if pid == n - 1 else (pid + 1) * (rows_n // n)
    feats = data.shards["per_user"]
    fi, fv = csr_to_padded(feats, rows_n)
    vocab = data.id_vocabs["userId"]
    rows = HostRows(entity_raw_ids=[vocab[i] for i in data.ids["userId"][lo:hi]],
                    row_index=np.arange(lo, hi, dtype=np.int64),
                    labels=data.response[lo:hi].astype(np.float32),
                    weights=data.weight[lo:hi].astype(np.float32),
                    offsets=data.offset[lo:hi].astype(np.float32), feat_idx=fi[lo:hi],
                    feat_val=fv[lo:hi], global_dim=feats.dim)
    prior_counts = payload["prior_counts"]
    budget = payload["budget"]
    prior_plan = EntityShardPlan.build(prior_counts, 1, global_dim=feats.dim,
                                       memory_budget_bytes=budget)
    got = {}

    def pin(v, counts):
        blocks, statuses = pin_prior_blocking(prior_plan, vocab, prior_counts, v, counts,
                                              payload["dirty"], global_dim=feats.dim,
                                              memory_budget_bytes=budget)
        got["statuses"] = statuses
        return blocks, statuses

    man = build_perhost_streaming_manifest(
        rows, RandomEffectDataConfig("userId", "per_user"),
        os.path.join(payload["outdir"], f"pinned-{n}-{pid}"), mh.mesh_context(), n, pid,
        memory_budget_bytes=budget, pin=pin)
    arrays = {}
    for g, b in zip(man.global_block_ids, man.blocks):
        with np.load(os.path.join(man.dir, b["file"])) as z:
            arrays[int(g)] = {k: z[k] for k in z.files}
    return {"blocks": [b.tolist() for b in EntityShardPlan.from_sidecars(man.dir).blocks],
            "statuses": list(got["statuses"]), "arrays": arrays}
