"""Persistent low-latency GAME scoring server on the card (port of
photon_ml_tpu/serve/server.py).

A warm process that loads a model once and answers scoring requests with
no per-request work beyond featurizing and the math:

  * coefficients come from the mmap'd :class:`~photon_ml_tpu_torch.serve.
    model_store.ModelStore` (no Avro parse; open is a handful of mmaps,
    per-entity lookup is a hash probe in mapped memory) and are uploaded
    to ``device`` once per model generation;
  * concurrent requests coalesce in the :class:`~photon_ml_tpu_torch.serve.
    batcher.MicroBatcher` onto the canonical shape ladder, so every batch
    has one of a small fixed set of shapes;
  * :meth:`ScoringServer.warmup` scores a zero batch at every (rows, nnz)
    ladder rung the request path can produce;
  * a live model roll goes through :class:`~photon_ml_tpu_torch.serve.swap.
    ModelSwapper` (the checkpoint by-reference protocol) without dropping
    in-flight requests.

Scoring mirrors ``cli/game_scoring_driver`` exactly: the fixed effect is
the driver's ``fixed_contrib``, an f32 random effect the driver's
``models.game.gather_scores``, both over the same pad-column-0 COO, and
contributions add in the driver's order (the offset, each fixed effect,
each random effect). Both sum a row's K terms with ``tree_row_sum``, whose
bits do not follow the row count or a zero-padded K, so served scores are
bitwise the batch driver's for the same inputs, on the CPU and on the
card. A bf16 or int8 slab stays on the device at its storage width and is
widened (and scaled) on the gathered ``(n, k)`` tile only.

The JAX server counts XLA traces per jitted site. The port runs eagerly
and compiles nothing, so a scoring site's counterpart of a warm executable
is a batch shape seen before: each site reports the first sight of its key
(batch rows, nnz, and the coefficients' dtype and shape) as a trace through
``compile.stats.instrumented_capture``. :meth:`warmup`,
:meth:`new_request_compiles` and the swap probe's ``new_compiles`` count
those first sights. XLA's persistent cache has no counterpart, so
:meth:`fully_warm` is False.

Request wire format (JSON lines on stdin via :func:`serve_json_lines`, or
the in-process :meth:`ScoringServer.score_rows` API):

    {"id": "r1", "rows": [{"features": {"<section>": [{"name": ...,
        "term": ..., "value": ...}, ...]}, "ids": {"<idType>": "<raw>"},
        "offset": 0.0}, ...]}
    -> {"id": "r1", "scores": [...]}

Control lines: ``{"cmd": "stats"}``, ``{"cmd": "swap", "store_dir": ...}``,
``{"cmd": "shutdown"}``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.compile import (
    ShapeBucketer,
    compile_stats,
    instrumented_capture,
    resolve_bucketer,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.io.index_map import feature_key
from photon_ml_tpu_torch.models.game import gather_scores
from photon_ml_tpu_torch.ops.fused_sparse import tree_row_sum
from photon_ml_tpu_torch.serve.batcher import MicroBatcher, RowBatch
from photon_ml_tpu_torch.serve.model_store import ModelStore
from photon_ml_tpu_torch.serve.stats import ServeStats, serve_stats

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

#: default nnz cap the warmup assumes per shard (requests wider than the
#: warmed rungs still work — each new shape is counted on first sight)
DEFAULT_WARM_NNZ = 64

#: the keys each scoring site has seen, process-wide (the counterpart of a
#: jitted function's trace cache)
_SEEN: Dict[str, dict] = {"serve.fixed_contrib": {}, "serve.re_gather": {}}


def _at_site(site: str, key: Hashable, fn: Callable[[], Tensor]) -> Tensor:
    """Run ``fn`` eagerly, counting the first sight of ``key`` at ``site``
    as a trace and every call as a call."""
    return instrumented_capture(site, key, _SEEN[site], lambda: True, lambda _: fn())


def re_gather_dequant(slab: Tensor, scales: Tensor, ent_pos: Tensor, idx: Tensor,
                      vals: Tensor) -> Tensor:
    """The quantized-store variant of ``gather_scores``: gather the stored
    elements (bf16 or int8), widen them to f32 and multiply by their slab
    row's scale on the gathered ``(n, k)`` tile, then the same masked
    K-sum. For a bf16 slab ``scales`` is all ones (``x * 1.0`` is exact)."""
    safe_e = torch.clamp_min(ent_pos, 0)
    gathered = slab[safe_e[:, None], idx].to(torch.float32)
    gathered = gathered * scales[safe_e][:, None]
    valid = ent_pos[:, None] >= 0
    return tree_row_sum(torch.where(valid, gathered * vals, torch.zeros_like(gathered)))


def _concat_futures(parts: List) -> "Future":
    """One Future resolving to the row-concatenation of ``parts`` (first
    part failure wins; remaining parts are ignored once failed)."""
    from concurrent.futures import Future

    combined: Future = Future()
    results: List[Optional[np.ndarray]] = [None] * len(parts)
    remaining = [len(parts)]
    lock = threading.Lock()

    def on_part(i: int, fut) -> None:
        try:
            results[i] = fut.result()
        except Exception as e:  # noqa: BLE001 — fan the failure to the caller
            with lock:
                if not combined.done():
                    combined.set_exception(e)
            return
        with lock:
            remaining[0] -= 1
            if remaining[0] == 0 and not combined.done():
                combined.set_result(np.concatenate(results))

    for i, fut in enumerate(parts):
        fut.add_done_callback(lambda f, i=i: on_part(i, f))
    return combined


@dataclasses.dataclass
class _ModelBundle:
    """One model generation resident on the device: read-only coefficient
    tensors + the host-side lookup handles that featurized this
    generation's requests. Never mutated — a swap installs a NEW bundle.
    Requests pinned to the generation are counted in and out, so the
    swapper's retire fence waits only on THIS generation; a queued batch
    holds the bundle (through its scoring closure), so its tensors live
    until the last pinned request is scored."""

    generation: int
    store: ModelStore
    fixed: List[tuple]  # (name, shard, w_dev)
    random: List[tuple]  # (name, re_id, shard, slab_dev, scales_dev|None)
    score_fn: Optional[Callable] = None  # bound by the server after build
    _inflight: int = 0
    _retired: bool = False
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    _idle: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )

    def __post_init__(self):
        self._idle.set()

    def begin_request(self) -> bool:
        """Pin one request to this generation; False once retired (the
        caller must re-read the current bundle and pin THAT — closes the
        read-then-pin race against a concurrent swap's store close)."""
        with self._lock:
            if self._retired:
                return False
            self._inflight += 1
            self._idle.clear()
            return True

    def end_request(self, _fut=None) -> None:
        with self._lock:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()

    def retire_if_idle(self) -> bool:
        """Atomically mark retired iff nothing is pinned; after True no
        begin_request can succeed, so the store is safe to close."""
        with self._lock:
            if self._inflight:
                return False
            self._retired = True
            return True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until no request is featurizing against or queued for this
        generation (then its store's mmaps are safe to close)."""
        return self._idle.wait(timeout)


class ScoringServer:
    """In-process scoring API + the engine under the JSON-lines loop.

    ``device``: where the coefficients live and the batches are scored
    (``None`` = ``cuda``, which raises without a card; the tests pass
    ``cpu``)."""

    def __init__(
        self,
        store: ModelStore,
        shard_sections: Optional[Dict[str, List[str]]] = None,
        bucketer: "Optional[ShapeBucketer | str | bool]" = "on",
        max_batch_rows: int = 128,
        max_wait_ms: float = 2.0,
        stats: Optional[ServeStats] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # an explicit index: the batcher's worker and the swapper set it
            # in their own threads
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the driver's own fixed-effect function (imported here: the
        # driver's module imports the training driver's)
        from photon_ml_tpu_torch.cli.game_scoring_driver import fixed_contrib

        self._fixed_contrib = fixed_contrib
        # the ladder defaults ON here (unlike training): a serving process
        # lives on a small set of batch shapes across arbitrary requests
        self.bucketer = resolve_bucketer(bucketer)
        self.shard_sections = shard_sections or {}
        self.stats = stats if stats is not None else serve_stats
        self._generation = 0
        self._swap_lock = threading.Lock()
        self._model = self._build_bundle(store)
        # footprint gauges update at INSTALL, not bundle build
        self.stats.record_store_footprint(**store.footprint())
        # the default scores against the CURRENT generation at call time —
        # binding a specific bundle's closure here would pin generation 1's
        # device slabs (and its store) for the server's whole life
        self.batcher = MicroBatcher(
            lambda batch: self._score_with(self._model, batch),
            max_batch_rows=max_batch_rows,
            max_wait_ms=max_wait_ms,
            bucketer=self.bucketer,
            stats=self.stats,
        ).start()
        self._request_watermark = compile_stats.watermark()

    # -- model install / swap ----------------------------------------------
    def _put(self, a: np.ndarray) -> Tensor:
        """A host array as a tensor on the device, in memory of its own
        (never a view of the store's mmap)."""
        return torch.from_numpy(np.array(a)).to(self.device)

    def _build_bundle(self, store: ModelStore) -> _ModelBundle:
        """Upload a store's coefficients to the device (outside any lock —
        slow) and bind its scoring closure. Quantized slabs upload at their
        storage width (bf16 or int8 residency on the device) plus the f32
        scale vector."""
        self._generation += 1
        random = []
        for r in store.random:
            if r.store_dtype == "f32":
                entry = (self._put(np.asarray(r.slab, np.float32)), None)
            elif r.store_dtype == "bf16":
                bits = torch.from_numpy(np.array(r.slab).view(np.int16))
                entry = (bits.view(torch.bfloat16).to(self.device),
                         torch.ones(r.slab.shape[0], dtype=torch.float32,
                                    device=self.device))
            else:  # int8
                entry = (self._put(np.asarray(r.slab, np.int8)),
                         self._put(np.asarray(r.scales, np.float32)))
            random.append((r.name, r.re_id, r.shard) + entry)
        bundle = _ModelBundle(
            generation=self._generation,
            store=store,
            fixed=[(f.name, f.shard, self._put(np.asarray(f.coefficients, np.float32)))
                   for f in store.fixed],
            random=random,
        )
        bundle.score_fn = lambda batch: self._score_with(bundle, batch)
        return bundle

    def install_bundle(self, store: ModelStore) -> _ModelBundle:
        """Atomically make ``store`` the current model; returns the OLD
        bundle (still valid for any in-flight request pinned to it — the
        swapper retires it after a drain)."""
        new = self._build_bundle(store)
        with self._swap_lock:
            old, self._model = self._model, new
        self.stats.record_store_footprint(**store.footprint())
        return old

    @property
    def model(self) -> _ModelBundle:
        return self._model

    @property
    def store(self) -> ModelStore:
        return self._model.store

    # -- scoring -------------------------------------------------------------
    def _score_with(self, bundle: _ModelBundle, batch: RowBatch) -> np.ndarray:
        """Device scoring of one padded batch against one model generation.
        Mirrors GameScoringDriver._score_device: the total starts at the
        offset, fixed-effect contributions add first, then random effects,
        with f32 adds between — the op sequence the batch driver runs."""
        if self.device.type == "cuda":
            # the batcher's worker and the swapper call in from threads of
            # their own
            torch.cuda.set_device(self.device.index)
        # one upload per shard, shared by every coordinate on that shard
        idx_dev = {s: self._put(a) for s, a in batch.shard_idx.items()}
        val_dev = {s: self._put(a) for s, a in batch.shard_val.items()}
        n = batch.num_rows
        total = self._put(np.asarray(batch.offset, np.float32))
        for _name, shard, w in bundle.fixed:
            idx, vals = idx_dev[shard], val_dev[shard]
            total = total + _at_site(
                "serve.fixed_contrib",
                (n, idx.shape[1], str(w.dtype), tuple(w.shape)),
                lambda: self._fixed_contrib(w, idx, vals))
        for name, _re_id, shard, slab, scales in bundle.random:
            idx, vals = idx_dev[shard], val_dev[shard]
            ent = self._put(batch.ent_row[name])
            total = total + _at_site(
                "serve.re_gather",
                (n, idx.shape[1], str(slab.dtype), tuple(slab.shape)),
                lambda: self._re_contrib(slab, scales, ent, idx, vals))
        return total.cpu().numpy()

    @staticmethod
    def _re_contrib(slab, scales, ent_dev, idx_dev, val_dev):
        """One random-effect coordinate's contribution: the driver's gather
        when the slab is f32 (bitwise contract), the dequantize-on-gather
        variant for bf16/int8 slabs."""
        if scales is None:
            return gather_scores(slab, ent_dev, idx_dev, val_dev)
        return re_gather_dequant(slab, scales, ent_dev, idx_dev, val_dev)

    def featurize(
        self, rows: List[dict], bundle: Optional[_ModelBundle] = None
    ) -> RowBatch:
        """Request rows -> host COO against a model generation's feature
        space. Per-row feature order matches the batch driver's ingest
        (sections in configured order, record order within a section,
        intercept appended last) so the per-row K-sum is term-for-term the
        driver's."""
        bundle = bundle or self._model
        store = bundle.store
        n = len(rows)
        offsets = np.zeros(n, np.float32)
        per_shard: Dict[str, List[List[tuple]]] = {
            s: [] for s in store.feature_maps
        }
        for i, row in enumerate(rows):
            offsets[i] = float(row.get("offset") or 0.0)
            feats = row.get("features") or {}
            if isinstance(feats, list):  # bare list = the default section
                feats = {"features": feats}
            for shard, imap in store.feature_maps.items():
                entries = []
                for section in self.shard_sections.get(shard) or ["features"]:
                    for f in feats.get(section) or []:
                        j = imap.get_index(
                            feature_key(f.get("name", ""), f.get("term", ""))
                        )
                        if j >= 0:
                            entries.append((j, float(f["value"])))
                if imap.intercept_index >= 0:
                    entries.append((imap.intercept_index, 1.0))
                per_shard[shard].append(entries)
        shard_idx, shard_val = {}, {}
        for shard, rows_entries in per_shard.items():
            k = max((len(e) for e in rows_entries), default=1) or 1
            idx = np.zeros((n, k), np.int32)
            val = np.zeros((n, k), np.float32)
            for i, entries in enumerate(rows_entries):
                for slot, (j, v) in enumerate(entries):
                    idx[i, slot] = j
                    val[i, slot] = v
            shard_idx[shard] = idx
            shard_val[shard] = val
        ent_row = {}
        for re in store.random:
            ids = np.full(n, -1, np.int32)
            for i, row in enumerate(rows):
                raw = (row.get("ids") or {}).get(re.re_id)
                ids[i] = re.rows.get_row(str(raw)) if raw is not None else -1
            ent_row[re.name] = ids
        return RowBatch(
            offset=offsets, shard_idx=shard_idx, shard_val=shard_val,
            ent_row=ent_row,
        )

    def submit_rows(self, rows: List[dict]):
        """Non-blocking scoring: featurize against the CURRENT generation
        and pin the request to it. Returns a Future of (n,) scores.

        A request wider than ``max_batch_rows`` is split into cap-sized
        sub-batches (scores are row-independent, so the concatenation is
        bit-identical) — one giant request must not form a batch padded
        past the top warmed ladder rung."""
        cap = self.batcher.max_batch_rows
        if len(rows) > cap:
            parts = [
                self.submit_rows(rows[i : i + cap])
                for i in range(0, len(rows), cap)
            ]
            return _concat_futures(parts)
        while True:
            bundle = self._model  # the pin travels with the batch
            if bundle.begin_request():
                break
            # lost the race with a swap retiring this generation; the
            # CURRENT bundle (never retired while installed) is next read
        try:
            batch = self.featurize(rows, bundle)
            fut = self.batcher.submit(batch, score_fn=bundle.score_fn)
        except BaseException:  # noqa: BLE001 — unpin-and-reraise: the generation pin must not leak on ANY failure (incl. KeyboardInterrupt), or swap's drain fence waits forever
            bundle.end_request()
            raise
        fut.add_done_callback(bundle.end_request)
        return fut

    def score_rows(self, rows: List[dict]) -> np.ndarray:
        if not rows:
            return np.zeros(0, np.float32)
        return self.submit_rows(rows).result()

    # -- warmup / shape accounting -----------------------------------------
    def _zero_batch(self, bundle: _ModelBundle, n: int, k: int) -> RowBatch:
        """Synthetic all-zero (n rows, k nnz) batch shaped like a real
        featurized request against ``bundle`` — the ONE batch layout the
        warmup rungs and the swap probe both score."""
        return RowBatch(
            offset=np.zeros(n, np.float32),
            shard_idx={
                s: np.zeros((n, k), np.int32)
                for s in bundle.store.feature_maps
            },
            shard_val={
                s: np.zeros((n, k), np.float32)
                for s in bundle.store.feature_maps
            },
            ent_row={
                r.name: np.full(n, -1, np.int32) for r in bundle.store.random
            },
        )

    def _ladder_rungs(self, lo: int, hi: int) -> List[int]:
        if self.bucketer is None:
            return [hi]
        rungs, r = [], self.bucketer.canon(max(lo, 1))
        top = self.bucketer.canon(hi)
        while True:
            rungs.append(r)
            if r >= top:
                return rungs
            r = self.bucketer.canon(r + 1)

    def warmup(self, warm_nnz: Optional[int] = None) -> dict:
        """Score synthetic zero batches at every (batch-rows, nnz) ladder
        rung the request path can produce, so steady-state requests meet
        no new shape."""
        wm = compile_stats.watermark()
        max_dim = max(
            (len(m) for m in self.store.feature_maps.values()), default=1
        )
        cap = min(max_dim, warm_nnz or DEFAULT_WARM_NNZ)
        n_rungs = self._ladder_rungs(1, self.batcher.max_batch_rows)
        k_rungs = self._ladder_rungs(1, cap)
        bundle = self._model
        batches = 0
        for n in n_rungs:
            for k in k_rungs:
                self._score_with(bundle, self._zero_batch(bundle, n, k))
                batches += 1
        self._request_watermark = compile_stats.watermark()
        return {
            "warm_batches": batches,
            "row_rungs": n_rungs,
            "nnz_rungs": k_rungs,
            "new_traces": wm.new_traces(),
            "new_xla_misses": wm.new_xla_misses(),
        }

    def fully_warm(self) -> bool:
        """The JAX server's "zero new XLA compiles from the persistent
        cache". The port has no such cache (``install_xla_listeners`` is
        False), so this is always False."""
        return compile_stats.install_xla_listeners() and compile_stats.xla_cache_misses == 0

    def new_request_compiles(self) -> int:
        """New shapes since warmup finished — nonzero means a request shape
        escaped the warmed ladder (widen warm_nnz / max_batch_rows)."""
        return self._request_watermark.new_traces()

    # ------------------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.batcher.drain(timeout)

    def close(self) -> None:
        self.batcher.close()
        self._model.store.close()


def serve_json_lines(
    server: ScoringServer,
    in_stream,
    out_stream,
    swapper=None,
) -> int:
    """Blocking JSON-lines request loop (no network framework — pipe the
    server behind whatever transport the deployment has). Returns the
    number of scoring requests handled. Responses are written in COMPLETION
    order (micro-batching reorders under concurrency) and always carry the
    request's ``id``."""
    handled = 0
    # fence on RESPONSES ENQUEUED, not futures resolved: the batcher's idle
    # event flips on the first done-callback, but the response enqueue is a
    # later callback — draining the batcher alone could return with the
    # last response still pending
    resp_lock = threading.Lock()
    resp_outstanding = 0
    resp_idle = threading.Event()
    resp_idle.set()
    # responses are WRITTEN by a dedicated thread: done-callbacks run on
    # the batcher's scoring worker, and a consumer that stops reading the
    # out stream must stall only this queue, never the device loop
    resp_q: "queue.Queue[Optional[dict]]" = queue.Queue()

    def _writer() -> None:
        while True:
            payload = resp_q.get()
            if payload is None:
                return
            out_stream.write(json.dumps(payload) + "\n")
            out_stream.flush()

    writer = threading.Thread(
        target=_writer, name="photon-serve-responder", daemon=True
    )
    writer.start()

    def respond(payload: dict) -> None:
        resp_q.put(payload)

    def on_done(req_id, fut) -> None:
        nonlocal resp_outstanding
        try:
            scores = fut.result()
            respond({"id": req_id, "scores": [float(s) for s in scores]})
        except Exception as e:  # noqa: BLE001 — a bad request must not kill the loop
            respond({"id": req_id, "error": f"{type(e).__name__}: {e}"})
        finally:
            with resp_lock:
                resp_outstanding -= 1
                if resp_outstanding == 0:
                    resp_idle.set()

    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError as e:
            respond({"error": f"bad JSON: {e}"})
            continue
        cmd = msg.get("cmd")
        if cmd == "shutdown":
            break
        if cmd == "stats":
            respond(
                {
                    "id": msg.get("id"),
                    "stats": server.stats.snapshot(),
                    "new_request_compiles": server.new_request_compiles(),
                }
            )
            continue
        if cmd == "swap":
            if swapper is None:
                respond({"id": msg.get("id"), "error": "no swapper configured"})
                continue
            try:
                report = swapper.swap(msg.get("store_dir", ""))
                respond({"id": msg.get("id"), "swap": report})
            except Exception as e:  # noqa: BLE001 — a bad swap must not kill serving
                respond({"id": msg.get("id"), "error": f"{type(e).__name__}: {e}"})
            continue
        rows = msg.get("rows")
        if not isinstance(rows, list) or not rows:
            respond({"id": msg.get("id"), "error": "request needs a non-empty 'rows' list"})
            continue
        try:
            fut = server.submit_rows(rows)
        except Exception as e:  # noqa: BLE001 — malformed rows fail THIS request only
            respond({"id": msg.get("id"), "error": f"{type(e).__name__}: {e}"})
            continue
        handled += 1
        with resp_lock:
            resp_outstanding += 1
            resp_idle.clear()
        fut.add_done_callback(
            lambda f, req_id=msg.get("id"): on_done(req_id, f)
        )
    server.drain()
    resp_idle.wait()
    resp_q.put(None)  # after every enqueue: writer drains, then exits
    writer.join()
    return handled
