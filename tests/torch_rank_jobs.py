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
