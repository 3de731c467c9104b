"""Step checkpointing for GAME coordinate descent (port of
photon_ml_tpu/checkpoint.py, same on-disk layout).

After each coordinate update the full descent state (per-coordinate
parameters, score vectors, objective and validation histories, step
counter) is written atomically; a restart resumes from the last complete
step.

Format: one directory per step (``step-<n>/``) holding an ``arrays.npz``
with every tensor leaf and a ``meta.json`` with the state's structure
(spelled as the JAX package spells its pytrees), a config fingerprint that
must match on resume, and per-array SHA-256 checksums verified on restore
(a bit-rotten step is skipped with a warning and restore falls back to the
previous intact step). Writes go to a temp dir renamed into place through
the I/O retry policy, so a crash mid-write never corrupts the latest
checkpoint, and stale temp dirs are swept when a checkpointer opens.

Leaves leave the card with ``.cpu()`` before ``np.savez``. numpy has no
bfloat16, so a bf16 leaf is stored as its ``uint16`` bit pattern and its
dtype recorded under ``meta["dtypes"]`` (a key written only when such a
leaf exists).

:meth:`CoordinateDescentCheckpointer._prepare` (the host snapshot) and
``_commit`` (retry + atomic rename) are split so that
:class:`photon_ml_tpu_torch.checkpoint_async.AsyncCheckpointer` can run the
commit on a background thread. ``CheckpointState.partial`` carries a
drain inside an update (the solve scheduler's ``kind="scheduler"``
snapshot, or the bucketed coordinate's ``"bucketed_re"`` progress) as
``partial.*`` arrays and the ``partial`` meta, as the JAX package lays it
out; a restore hands it back (the streaming random effect's
``"streaming_re"`` block progress too). A leaf with the by-reference
protocol (``__checkpoint_ref__`` / ``__checkpoint_from_ref__``: the
streaming coordinate's spilled state, already durable on disk) is stored
as a JSON ref in the structure instead of arrays; a ref that cannot be
rebuilt (a spill dir written and since removed) raises
:class:`CheckpointRefError`, and restore falls back to an older step.

Multihost (``multihost=`` a ``parallel.multihost.MultihostContext``): every
rank snapshots together (the leaves ``sharded`` names, a coordinate's
per-rank entity blocks, are all-gathered in rank order into the global
array), ONLY the coordinator writes, and a barrier fences the write; a
restore agrees on the step with a collective min over every rank's latest
complete step and hands each rank its own block of the sharded leaves. The
directory is shared by the ranks. With ``per_rank=True`` (the per-host
streaming coordinates, whose spilled-state references and mid-update
progress are each rank's own) every rank writes its own directory instead,
still fenced by a barrier, and the restore's collective min picks a step
every rank holds. The plan-versioned elastic restore is not yet ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.resilience import faults

STEP_PREFIX = "step-"
TMP_PREFIX = ".ckpt-"
ARRAYS_FILE = "arrays.npz"
META_FILE = "meta.json"

logger = logging.getLogger(__name__)


def fingerprint(parts: Dict[str, Any]) -> str:
    """Stable hash of the run configuration (coordinate names, row count,
    anything the caller adds); resuming with a different fingerprint fails."""
    blob = json.dumps(parts, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to photon_ml_tpu_torch")


def _flatten(value: Any) -> Tuple[List[Any], str]:
    """(leaves, structure) of a tensor or dicts/lists/tuples of tensors, in
    a JAX pytree's leaf order (dict keys sorted) and spelling
    (``PyTreeDef({'fixed': *, 'per-user': *})``). An object with
    ``tree_flatten`` (``FactoredState``) is a custom node, spelled as JAX
    spells a registered class: ``CustomNode(FactoredState[None], [*, *])``."""
    leaves: List[Any] = []

    def walk(v: Any) -> str:
        if isinstance(v, dict):
            return "{" + ", ".join(f"{k!r}: {walk(v[k])}" for k in sorted(v)) + "}"
        if isinstance(v, tuple):
            return "(" + ", ".join(walk(x) for x in v) + ("," if len(v) == 1 else "") + ")"
        if isinstance(v, list):
            return "[" + ", ".join(walk(x) for x in v) + "]"
        if hasattr(v, "tree_flatten"):
            children, aux = v.tree_flatten()
            return (f"CustomNode({type(v).__name__}[{aux}], ["
                    + ", ".join(walk(x) for x in children) + "])")
        leaves.append(v)
        return "*"

    return leaves, f"PyTreeDef({walk(value)})"


def _unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in _flatten's order."""
    it = iter(leaves)

    def build(v: Any) -> Any:
        if isinstance(v, dict):
            return {k: build(v[k]) for k in sorted(v)}
        if isinstance(v, (tuple, list)):
            return type(v)(build(x) for x in v)
        if hasattr(v, "tree_flatten"):
            children, aux = v.tree_flatten()
            return type(v).tree_unflatten(aux, [build(x) for x in children])
        return next(it)

    return build(template)


class CheckpointRefError(ValueError):
    """A by-reference leaf could not be rebuilt (wrong kind, stale ref);
    restore treats the step as unusable and falls back."""


def _is_ref_leaf(x: Any) -> bool:
    return hasattr(x, "__checkpoint_ref__")


def rebuild_from_ref(template: Any, ref: Any) -> Any:
    """A by-reference leaf rebuilt from its stored JSON ref through the
    template leaf's ``__checkpoint_from_ref__``."""
    if not hasattr(template, "__checkpoint_from_ref__"):
        raise CheckpointRefError(
            f"cannot rebuild {type(template).__name__} from a reference: "
            "the template has no __checkpoint_from_ref__"
        )
    return template.__checkpoint_from_ref__(ref)


def _leaf_to_host(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A private host copy of ``leaf`` and, for bf16, the dtype to record."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _leaf_from_host(arr: np.ndarray, dtype: Optional[str], template: Any) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    device = template.device if isinstance(template, torch.Tensor) else "cpu"
    return t.to(device)


def _flatten_state(state: Dict[str, Any]):
    """State dict -> (flat arrays, structure, bf16 dtypes by array name)."""
    arrays: Dict[str, np.ndarray] = {}
    structure: Dict[str, Any] = {}
    dtypes: Dict[str, str] = {}
    for name, value in state.items():
        leaves, treedef = _flatten(value)
        refs: Dict[str, Any] = {}
        structure[name] = {"num_leaves": len(leaves), "treedef": treedef, "refs": refs}
        for i, leaf in enumerate(leaves):
            if _is_ref_leaf(leaf):
                refs[str(i)] = leaf.__checkpoint_ref__()
                continue
            arrays[f"{name}.{i}"], dtype = _leaf_to_host(leaf)
            if dtype is not None:
                dtypes[f"{name}.{i}"] = dtype
    return arrays, structure, dtypes


def _unflatten_state(template: Dict[str, Any], arrays: Dict[str, np.ndarray],
                     structure: Dict[str, Any], dtypes: Dict[str, str]) -> Dict[str, Any]:
    """Rebuild state using the caller's template for structure and device."""
    out: Dict[str, Any] = {}
    for name, value in template.items():
        leaves, treedef = _flatten(value)
        if name not in structure:
            raise ValueError(f"checkpoint missing state entry {name!r}")
        if structure[name]["num_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint entry {name!r} has {structure[name]['num_leaves']} "
                f"leaves, template expects {len(leaves)}"
            )
        if structure[name]["treedef"] != treedef:
            # the same leaf count in another structure would put arrays in
            # the wrong slots
            raise ValueError(
                f"checkpoint entry {name!r} structure {structure[name]['treedef']} "
                f"does not match template {treedef}; refusing to resume"
            )
        refs = structure[name].get("refs") or {}
        for i, leaf in enumerate(leaves):
            if str(i) in refs:
                if not _is_ref_leaf(leaf):
                    raise CheckpointRefError(
                        f"checkpoint entry {name!r} leaf {i} was saved by "
                        "reference but the template leaf has no "
                        "__checkpoint_from_ref__ — coordinate types changed"
                    )
                continue
            # the same structure with other shapes (a bucketed coordinate
            # whose buckets were rebuilt differently) would train the wrong
            # entities from the restored stacks
            got, want = arrays[f"{name}.{i}"].shape, tuple(torch.as_tensor(leaf).shape)
            if tuple(got) != want:
                raise ValueError(
                    f"checkpoint entry {name!r} leaf {i} has shape {tuple(got)}, this run's "
                    f"state {want}; refusing to resume"
                )
        out[name] = _unflatten(value, [
            rebuild_from_ref(leaf, refs[str(i)]) if str(i) in refs else
            _leaf_from_host(arrays[f"{name}.{i}"], dtypes.get(f"{name}.{i}"), leaf)
            for i, leaf in enumerate(leaves)
        ])
    return out


def _checksums(arrays: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Per-array SHA-256 over the raw bytes, verified on restore."""
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def _verify_checksums(arrays: Dict[str, np.ndarray], expected: Dict[str, str],
                      path: str) -> None:
    """Raise ValueError naming the first mismatched array."""
    for k, digest in expected.items():
        if k not in arrays:
            raise ValueError(
                f"checkpoint {path} is missing array {k!r} listed in its "
                "meta checksums — truncated or tampered step"
            )
        got = hashlib.sha256(np.ascontiguousarray(arrays[k]).tobytes()).hexdigest()
        if got != digest:
            raise ValueError(
                f"checkpoint {path} array {k!r} fails its SHA-256 check "
                f"({got[:12]} != recorded {digest[:12]}) — bit-rotten step; "
                "restore falls back to the previous intact step (delete "
                f"{path} to silence this warning)"
            )


@dataclasses.dataclass
class CheckpointState:
    """Everything needed to resume mid-descent."""

    step: int  # completed (iteration * num_coordinates + coordinate) updates
    params: Dict[str, Any]  # coordinate name -> params
    scores: Dict[str, Any]  # coordinate name -> (N,) score vector
    total_scores: Any  # (N,)
    objective_history: List[float]
    validation_history: List[Dict[str, float]]
    # a drain inside an update: the in-flight coordinate's progress
    # ({"meta", "arrays"}; meta names the coordinate and its resume_step)
    partial: Optional[Dict[str, Any]] = None


#: the mid-coordinate payload kinds a restore hands back to a coordinate
RESUMABLE_PARTIALS = ("scheduler", "bucketed_re", "streaming_re")


def _sharded_flat_indices(params: Dict[str, Any], sharded: Dict[str, Any]) -> List[int]:
    """Positions, among the flattened leaves of ``params`` (dict keys
    sorted, as ``_flatten`` walks them), of the leaves ``sharded`` names
    (coordinate -> indices among that coordinate's own leaves)."""
    out, base = [], 0
    for name in sorted(params):
        n = len(_flatten(params[name])[0])
        out.extend(base + int(i) for i in sharded.get(name, ()))
        base += n
    return out


class CoordinateDescentCheckpointer:
    """Atomic per-step checkpoint writer/reader with retention."""

    def __init__(self, directory: str, run_fingerprint: str = "", keep: int = 2,
                 multihost=None, sharded: Optional[Dict[str, Any]] = None,
                 per_rank: bool = False):
        """``multihost``/``sharded``/``per_rank``: see the module docstring;
        ``sharded`` maps a coordinate to the indices of its state's leaves
        that are the rank's entity block (a coordinate's
        ``rank_sharded_leaves``)."""
        self.directory = directory
        self.run_fingerprint = run_fingerprint
        self.keep = max(keep, 1)
        self.multihost = multihost
        self.sharded = dict(sharded or {})
        self.per_rank = per_rank
        if self.writes():
            os.makedirs(directory, exist_ok=True)
            self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> None:
        """Remove ``.ckpt-*`` debris a crashed writer left behind (a temp dir
        never renamed into place is by definition incomplete)."""
        for name in os.listdir(self.directory):
            if name.startswith(TMP_PREFIX):
                stale = os.path.join(self.directory, name)
                logger.warning("removing stale checkpoint temp dir %s", stale)
                shutil.rmtree(stale, ignore_errors=True)

    def writes(self) -> bool:
        """Whether this rank commits: always outside multihost, the
        coordinator alone in a shared directory, every rank with
        ``per_rank``."""
        return (self.multihost is None or self.per_rank
                or self.multihost.coordinator_only_io())

    def _gathers(self) -> bool:
        return (self.multihost is not None and self.multihost.num_processes > 1
                and bool(self.sharded))

    def _step_dirs(self) -> List[Tuple[int, str]]:
        out = []
        if not os.path.isdir(self.directory):
            # a rank whose coordinator never wrote here: no steps (the
            # collective min in restore settles what the job resumes)
            return out
        for name in os.listdir(self.directory):
            if name.startswith(STEP_PREFIX):
                try:
                    step = int(name[len(STEP_PREFIX):])
                except ValueError:
                    continue
                path = os.path.join(self.directory, name)
                if os.path.exists(os.path.join(path, META_FILE)):
                    out.append((step, path))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    # ------------------------------------------------------------------
    def _prepare(self, state: CheckpointState) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        """Host snapshot of ``state``: (flat arrays, meta). A collective
        under multihost (the sharded leaves are all-gathered): every rank
        calls it together."""
        params = state.params
        if self._gathers():
            ctx = self.multihost.mesh_context()
            params = {}
            for name, value in state.params.items():
                leaves, _ = _flatten(value)
                idx = set(int(i) for i in self.sharded.get(name, ()))
                params[name] = _unflatten(value, [ctx.concat(leaf) if i in idx else leaf
                                                  for i, leaf in enumerate(leaves)])
        arrays, structure, dtypes = _flatten_state(
            {"params": params, "scores": state.scores, "total": state.total_scores}
        )
        partial_meta = None
        if state.partial is not None:
            partial_meta = state.partial.get("meta") or {}
            for k, v in (state.partial.get("arrays") or {}).items():
                arrays[f"partial.{k}"] = np.asarray(v)
        meta = {
            "step": state.step,
            "fingerprint": self.run_fingerprint,
            "structure": structure,
            "objective_history": state.objective_history,
            "validation_history": state.validation_history,
            "partial": partial_meta,
        }
        if dtypes:
            meta["dtypes"] = dtypes
        return arrays, meta

    def _commit(self, step: int, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> str:
        """Durably write one prepared snapshot (retry + atomic rename) and
        retire old steps. Pure host I/O — safe on a background thread."""
        final_dir = os.path.join(self.directory, f"{STEP_PREFIX}{step}")
        meta = dict(meta, checksums=_checksums(arrays))

        def write_once() -> None:
            """One attempt: fresh temp dir -> rename; the temp dir is removed
            on any failure, so a retry never inherits partial state."""
            faults.inject("io.checkpoint_write", step=step, path=final_dir)
            tmp_dir = tempfile.mkdtemp(prefix=TMP_PREFIX, dir=self.directory)
            renamed = False
            try:
                np.savez(os.path.join(tmp_dir, ARRAYS_FILE), **arrays)
                with open(os.path.join(tmp_dir, META_FILE), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final_dir):
                    shutil.rmtree(final_dir)
                os.replace(tmp_dir, final_dir)
                renamed = True
            finally:
                if not renamed:
                    shutil.rmtree(tmp_dir, ignore_errors=True)

        resilience.call_with_retry(
            write_once,
            resilience.current_config().io_policy,
            describe=f"checkpoint step {step}",
            on_retry=lambda a, e, d: logger.warning(
                "retrying checkpoint step %d (attempt %d): %s", step, a + 2, e
            ),
        )
        self._retire()
        return final_dir

    def save(self, state: CheckpointState) -> str:
        arrays, meta = self._prepare(state)
        mh = self.multihost
        if not self.writes():
            # the other ranks fence the coordinator's write
            mh.barrier("ckpt-write")
            return os.path.join(self.directory, f"{STEP_PREFIX}{state.step}")
        try:
            return self._commit(state.step, arrays, meta)
        finally:
            # even when the write fails: the other ranks already wait in
            # their barrier, and skipping it would strand them until the
            # timeout instead of surfacing the coordinator's exception
            if mh is not None:
                mh.barrier("ckpt-write")

    def wait(self) -> None:
        """Every save of this checkpointer is durable when it returns, so the
        fence is a no-op (the async wrapper overrides it)."""

    def _retire(self) -> None:
        for _, path in self._step_dirs()[: -self.keep]:
            shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, params_template: Dict[str, Any], scores_template: Dict[str, Any],
                total_template: Any) -> Optional[CheckpointState]:
        """Load the newest complete checkpoint; None when there is none.

        Under multihost the steps considered stop at the collective min of
        every rank's latest step, and a rank with none means a fresh start:
        a collective, so every rank restores together.

        Stale ``.ckpt-*`` temp dirs are never candidates, and a step whose
        ``arrays.npz`` is truncated, undecodable or fails its checksums is
        skipped with a warning in favour of the next-newest. Reads retry
        under the active I/O policy. The templates give the structure and
        the device of the restored tensors; a fingerprint mismatch raises.
        """
        max_step = None
        if self.multihost is not None:
            max_step = self.multihost.agree_restore_step(self.latest_step())
            if max_step is None:
                return None
        policy = resilience.current_config().io_policy
        for step, path in reversed(self._step_dirs()):
            if max_step is not None and step > max_step:
                continue

            def load_meta() -> dict:
                with open(os.path.join(path, META_FILE)) as f:
                    return json.load(f)

            try:
                meta = resilience.call_with_retry(load_meta, policy, describe=f"read {path} meta")
            except (resilience.RetryError, ValueError) as e:
                logger.warning("skipping unreadable checkpoint %s: %s", path, e)
                continue
            if meta.get("fingerprint") != self.run_fingerprint:
                raise ValueError(
                    f"checkpoint fingerprint {meta.get('fingerprint')!r} does not match "
                    f"this run ({self.run_fingerprint!r}); refusing to resume"
                )
            partial_meta = meta.get("partial")
            if partial_meta is not None and partial_meta.get("kind") not in RESUMABLE_PARTIALS:
                raise _not_ported(f"resuming inside a coordinate from a "
                                  f"{partial_meta.get('kind')!r} payload")

            def load_arrays() -> Dict[str, np.ndarray]:
                with np.load(os.path.join(path, ARRAYS_FILE)) as npz:
                    return {k: npz[k] for k in npz.files}

            try:
                arrays = resilience.call_with_retry(load_arrays, policy,
                                                    describe=f"read {path} arrays")
                if meta.get("checksums"):
                    _verify_checksums(arrays, meta["checksums"], path)
            except (resilience.RetryError, zipfile.BadZipFile, ValueError, EOFError) as e:
                logger.warning("skipping corrupt checkpoint %s: %s", path, e)
                continue
            partial = None
            if partial_meta is not None:
                partial = {"meta": partial_meta,
                           "arrays": {k[len("partial."):]: arrays.pop(k) for k in list(arrays)
                                      if k.startswith("partial.")}}
            if self._gathers():
                # this rank's block of every gathered leaf
                leaves = _flatten(params_template)[0]
                rank = self.multihost.process_id
                for i in _sharded_flat_indices(params_template, self.sharded):
                    per = torch.as_tensor(leaves[i]).shape[0]
                    arrays[f"params.{i}"] = arrays[f"params.{i}"][rank * per:(rank + 1) * per]
            try:
                restored = _unflatten_state(
                    {"params": params_template, "scores": scores_template,
                     "total": total_template},
                    arrays, meta["structure"], meta.get("dtypes") or {},
                )
            except CheckpointRefError as e:
                logger.warning("skipping unrestorable checkpoint %s: %s", path, e)
                continue
            return CheckpointState(
                step=int(meta["step"]),
                params=restored["params"],
                scores=restored["scores"],
                total_scores=restored["total"],
                objective_history=list(meta["objective_history"]),
                validation_history=list(meta["validation_history"]),
                partial=partial,
            )
        return None
