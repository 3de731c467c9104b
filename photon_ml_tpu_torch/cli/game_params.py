"""GAME driver parameters: delimited-string configs and the command-line
parsers of the training and scoring drivers (port of
photon_ml_tpu/cli/game_params.py).

Reference spec: cli/game/training/Params.scala:196-395 and its config
grammars:

  per-coordinate optimization config (GLMOptimizationConfiguration.scala:41-75):
      maxIter,tol,regWeight,downSamplingRate,optimizer,regType
  coordinate map: "name:cfg|name2:cfg2"
  fixed-effect data config: "name:shardId,minPartitions"
  random-effect data config (RandomEffectDataConfiguration.scala:60-124):
      "name:reId,shardId,numPartitions,activeUB,passiveLB,featureRatio,projector"
  feature shard map: "shard1:sec1,sec2|shard2:sec3"
  factored config (MFOptimizationConfiguration.scala): REcfg:latentCfg:mfIters,latentDim

The training parser takes every flag of the JAX driver under the same name,
plus ``--device`` (default ``cuda``). Grid alternatives are ';'-separated
(``config_grid`` is their Cartesian product). ``validate`` rejects, naming
the flag, every flag whose code path is not yet ported when it is set away
from its default: the fused cycle, the mesh and the persistent cache
(``_FENCED``). Streaming random effects (``--streaming-random-effects``,
``--re-memory-budget-mb``, which implies it), ``--tensor-cache``,
``--export-serve-store`` with ``--store-dtype``, the delta retrain
(``--warm-start-from``) and the planner (``--plan off|auto``) run.
``--solve-compaction`` and ``--adaptive-schedule`` are checked through the
execution plan (compile/plan.py), as the JAX parser checks them. The scoring parser takes every flag of the JAX
scoring driver, plus ``--device``. The serve parser takes every flag of the
JAX serve driver, plus ``--device``; ``--persistent-cache`` is fenced
there too.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
from typing import Dict, List, Optional, Tuple

from photon_ml_tpu_torch.data.game import RandomEffectDataConfig
from photon_ml_tpu_torch.evaluation.evaluators import EvaluatorType
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.types import ModelOutputMode, OptimizerType, RegularizationType, TaskType


@dataclasses.dataclass(frozen=True)
class CoordinateOptConfig:
    """One coordinate's solve configuration (GLMOptimizationConfiguration
    parity; the reference default is TRON(20, 1e-5), no reg, no sampling)."""

    optimizer: OptimizerType = OptimizerType.TRON
    max_iterations: int = 20
    tolerance: float = 1e-5
    reg_weight: float = 0.0
    reg_type: RegularizationType = RegularizationType.NONE
    down_sampling_rate: float = 1.0

    @staticmethod
    def parse(s: str) -> "CoordinateOptConfig":
        parts = [p.strip() for p in s.split(",")]
        if len(parts) != 6:
            raise ValueError(
                f"Parsing {s!r} failed: expected 6 comma-separated parts "
                "(maxIter,tol,regWeight,downSamplingRate,optimizer,regType)"
            )
        max_iter, tol, reg_w, rate = int(parts[0]), float(parts[1]), float(parts[2]), float(parts[3])
        if not (0.0 < rate <= 1.0):
            raise ValueError(f"Unexpected downSamplingRate: {rate}")
        return CoordinateOptConfig(
            optimizer=OptimizerType(parts[4].upper()),
            max_iterations=max_iter,
            tolerance=tol,
            reg_weight=reg_w,
            reg_type=RegularizationType(parts[5].upper()),
            down_sampling_rate=rate,
        )

    def optimizer_config(self) -> OptimizerConfig:
        return OptimizerConfig(max_iterations=self.max_iterations, tolerance=self.tolerance)

    def regularization_context(self) -> RegularizationContext:
        if self.reg_type == RegularizationType.L1:
            return RegularizationContext.l1(self.reg_weight)
        if self.reg_type == RegularizationType.L2:
            return RegularizationContext.l2(self.reg_weight)
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return RegularizationContext.elastic_net(self.reg_weight, 0.5)
        return RegularizationContext.none()


def _chunks(s: Optional[str]):
    for chunk in (s or "").split("|"):
        chunk = chunk.strip()
        if chunk:
            yield chunk


def parse_coordinate_config_map(s: str) -> Dict[str, CoordinateOptConfig]:
    """"name:cfg|name2:cfg2" -> map."""
    out: Dict[str, CoordinateOptConfig] = {}
    for chunk in _chunks(s):
        name, cfg = chunk.split(":", 1)
        out[name.strip()] = CoordinateOptConfig.parse(cfg)
    return out


def parse_coordinate_config_grid(s: Optional[str]) -> List[Dict[str, CoordinateOptConfig]]:
    """';'-separated grid of coordinate config maps; empty -> [{}]."""
    if not s:
        return [{}]
    return [parse_coordinate_config_map(chunk) for chunk in s.split(";") if chunk.strip()]


@dataclasses.dataclass(frozen=True)
class FixedEffectDataSpec:
    feature_shard_id: str
    min_partitions: int = 1  # a Spark knob, accepted for parity


def parse_fixed_effect_data_configs(s: Optional[str]) -> Dict[str, FixedEffectDataSpec]:
    out: Dict[str, FixedEffectDataSpec] = {}
    for chunk in _chunks(s):
        name, cfg = chunk.split(":", 1)
        parts = [p.strip() for p in cfg.split(",")]
        if len(parts) != 2:
            raise ValueError(f"Parsing {cfg!r} failed: expected featureShardId,minPartitions")
        out[name.strip()] = FixedEffectDataSpec(parts[0], int(parts[1]))
    return out


def parse_random_effect_data_configs(s: Optional[str]) -> Dict[str, RandomEffectDataConfig]:
    """RandomEffectDataConfiguration.scala:60-124 grammar; negative bounds
    mean unbounded; projector RANDOM takes '=dim'."""
    out: Dict[str, RandomEffectDataConfig] = {}
    for chunk in _chunks(s):
        name, cfg = chunk.split(":", 1)
        parts = [p.strip() for p in cfg.split(",")]
        if len(parts) != 7:
            raise ValueError(
                f"Parsing {cfg!r} failed: expected reId,shardId,numPartitions,"
                "activeUpperBound,passiveLowerBound,featureRatio,projector"
            )
        active_ub, passive_lb, ratio = int(parts[3]), int(parts[4]), float(parts[5])
        proj = parts[6].split("=")
        proj_type = proj[0].upper()
        proj_dim = None
        if proj_type == "RANDOM":
            if len(proj) != 2:
                raise ValueError("RANDOM projector needs a dimension: RANDOM=projectedSpaceDimension")
            proj_dim = int(proj[1])
        out[name.strip()] = RandomEffectDataConfig(
            random_effect_id=parts[0],
            feature_shard_id=parts[1],
            num_shards=max(int(parts[2]), 1),
            active_upper_bound=active_ub if active_ub >= 0 else None,
            passive_lower_bound=passive_lb if passive_lb >= 0 else None,
            features_to_samples_ratio=ratio if ratio >= 0 else None,
            projector=proj_type,
            random_projection_dim=proj_dim,
        )
    return out


@dataclasses.dataclass(frozen=True)
class FactoredSpec:
    """Factored random effect: RE config + latent config + (mfIters, latentDim)
    (FactoredRandomEffectOptimizationProblem parity)."""

    random_effect: CoordinateOptConfig
    latent_factor: CoordinateOptConfig
    mf_num_iterations: int
    latent_dim: int


def parse_factored_config_map(s: Optional[str]) -> Dict[str, FactoredSpec]:
    """"name:REcfg:latentCfg:mfIters,latentDim|..." (three config strings a
    coordinate, ':'-separated)."""
    out: Dict[str, FactoredSpec] = {}
    for chunk in _chunks(s):
        name, re_cfg, latent_cfg, mf_cfg = chunk.split(":", 3)
        mf_parts = [p.strip() for p in mf_cfg.split(",")]
        if len(mf_parts) != 2:
            raise ValueError(f"Parsing {mf_cfg!r} failed: expected mfIters,latentDim")
        out[name.strip()] = FactoredSpec(
            CoordinateOptConfig.parse(re_cfg),
            CoordinateOptConfig.parse(latent_cfg),
            int(mf_parts[0]),
            int(mf_parts[1]),
        )
    return out


def parse_shard_sections(s: Optional[str]) -> Dict[str, List[str]]:
    """"shard1:sec1,sec2|shard2:sec3" -> shard -> section field list."""
    out: Dict[str, List[str]] = {}
    for chunk in _chunks(s):
        shard, secs = chunk.split(":", 1)
        out[shard.strip()] = [x.strip() for x in secs.split(",") if x.strip()]
    return out


def parse_shard_intercepts(s: Optional[str]) -> Dict[str, bool]:
    """"shard1:true|shard2:false"."""
    out: Dict[str, bool] = {}
    for chunk in _chunks(s):
        shard, flag = chunk.split(":", 1)
        out[shard.strip()] = flag.strip().lower() in ("true", "1", "yes")
    return out


def parse_evaluators(s: Optional[str]) -> List[Tuple[EvaluatorType, Optional[int], Optional[str]]]:
    """Comma list; precision@K spelled "PRECISION@K:idName" with K an int
    (EvaluatorType.scala withName parity). Returns (type, k, id name)."""
    out: List[Tuple[EvaluatorType, Optional[int], Optional[str]]] = []
    for tok in (s or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        up = tok.upper()
        if up.startswith("PRECISION@"):
            body = tok.split("@", 1)[1]
            k_s, id_name = body.split(":", 1) if ":" in body else (body, None)
            out.append((EvaluatorType.PRECISION_AT_K, int(k_s), id_name))
        else:
            out.append((EvaluatorType(up), None, None))
    return out


@dataclasses.dataclass
class GameTrainingParams:
    """cli/game/training/Params.scala parity, for the ported slice."""

    train_input_dirs: List[str] = dataclasses.field(default_factory=list)
    task_type: TaskType = TaskType.LOGISTIC_REGRESSION
    output_dir: str = ""
    updating_sequence: List[str] = dataclasses.field(default_factory=list)
    validate_input_dirs: Optional[List[str]] = None
    # daily/yyyy/MM/dd input discovery (IOUtils.scala:85-130); range XOR days-ago
    train_date_range: Optional[str] = None
    train_date_range_days_ago: Optional[str] = None
    validate_date_range: Optional[str] = None
    validate_date_range_days_ago: Optional[str] = None
    feature_shard_sections: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    feature_shard_intercepts: Dict[str, bool] = dataclasses.field(default_factory=dict)
    # deprecated NameAndTerm vocabulary dir (io/name_and_term.py)
    feature_name_and_term_set_path: Optional[str] = None
    num_iterations: int = 1
    fixed_effect_opt_grid: List[Dict[str, CoordinateOptConfig]] = dataclasses.field(
        default_factory=lambda: [{}]
    )
    random_effect_opt_grid: List[Dict[str, CoordinateOptConfig]] = dataclasses.field(
        default_factory=lambda: [{}]
    )
    fixed_effect_data_configs: Dict[str, FixedEffectDataSpec] = dataclasses.field(default_factory=dict)
    random_effect_data_configs: Dict[str, RandomEffectDataConfig] = dataclasses.field(
        default_factory=dict
    )
    factored_configs: Dict[str, FactoredSpec] = dataclasses.field(default_factory=dict)
    compute_variance: bool = False
    model_output_mode: ModelOutputMode = ModelOutputMode.BEST
    num_output_files_re_model: int = 1
    delete_output_dir_if_exists: bool = False
    application_name: str = "photon-ml-tpu-game"
    # feature maps from feature_indexing (JSON files or off-heap stores)
    offheap_indexmap_dir: Optional[str] = None
    evaluators: List[Tuple[EvaluatorType, Optional[int], Optional[str]]] = dataclasses.field(
        default_factory=list
    )
    # corrupt Avro shard policy: "raise" fails on the first bad block; "skip"
    # drops bad blocks (resyncing on the sync marker) up to the budget per
    # part file; every filesystem read retries io_retries times with
    # exponential backoff from io_retry_base_delay seconds
    on_corrupt: str = "raise"
    corrupt_skip_budget: int = 16
    io_retries: int = 4
    io_retry_base_delay: float = 0.05
    # step checkpoints (checkpoint.py), resumed automatically; commits on a
    # background thread with checkpoint_async
    checkpoint_dir: Optional[str] = None
    checkpoint_async: bool = False
    # on a cooperative preemption, relaunch in-process from the latest
    # checkpoint up to this many times before exiting with code 75
    max_restarts: int = 0
    # non-finite gate on coordinate updates: off | rollback | skip_cycle
    divergence_guard: str = "off"
    # "false" | "true" | "auto": a lambda-only grid trains through
    # CoordinateDescent.run_grid on coordinates built once; anything else
    # falls back (logged) to the per-combo rebuild
    vmapped_grid: str = "false"
    # size-bucketed per-entity solves (algorithm/bucketed_random_effect):
    # per-bucket padding on skewed entity distributions
    bucketed_random_effects: bool = False
    # out-of-core random effects (algorithm/streaming_random_effect.py): the
    # entity blocks stream from disk, sized by the budget (MB) when given
    streaming_random_effects: bool = False
    re_memory_budget_mb: Optional[float] = None
    # content-addressed cache of built ingest tensors (io/tensor_cache.py)
    tensor_cache_dir: Optional[str] = None
    # export the trained best model as an mmap'd serving store
    # (serve/model_store.py) right after save, with this slab policy
    # (serve/quantize.py): f32 (bitwise default) | bf16 | int8
    export_serve_store: Optional[str] = None
    store_dtype: str = "f32"
    # canonical shape ladder (compile/canonical.py): "off" | "on" |
    # "BASE:GROWTH"; each bucket's dims round up a geometric ladder with
    # masked padding
    shape_canonicalization: str = "off"
    # convergence-compacted random-effect solves (optim/scheduler.py):
    # "off" | "on" | CHUNK | "device[:CHUNK]"; None defers to
    # PHOTON_SOLVE_CHUNK
    solve_compaction: Optional[str] = None
    # adaptive bucket scheduling (optim/convergence.py): "off" | "on" | TOL
    # | "TOL:K"; None defers to PHOTON_ADAPTIVE_SCHEDULE
    adaptive_schedule: Optional[str] = None
    # delta retraining (retrain/): the prior run's output dir, whose
    # retrain.json the planner diffs the new inputs against; unchanged
    # coordinates and entity blocks skip their solves bitwise, dirty work
    # re-solves warm-started from the prior model
    warm_start_from: Optional[str] = None
    # the cost-based planner (compile/cost.py): "off" | "auto"; None
    # defers to PHOTON_PLAN
    plan: Optional[str] = None
    # flags of the JAX driver given away from their default whose code paths
    # are not yet ported (filled by the parser; validate refuses them)
    unported_flags: List[str] = dataclasses.field(default_factory=list)
    # where tensors live: "cuda" (default) or "cpu"
    device: str = "cuda"

    def validate(self) -> None:
        errors = []
        if self.re_memory_budget_mb is not None and self.re_memory_budget_mb <= 0:
            errors.append("--re-memory-budget-mb must be positive")
        # bools are accepted from programmatic construction
        if isinstance(self.vmapped_grid, bool):
            self.vmapped_grid = "true" if self.vmapped_grid else "false"
        if self.vmapped_grid not in ("false", "true", "auto"):
            errors.append(
                f"vmapped_grid must be 'false', 'true', or 'auto', got {self.vmapped_grid!r}"
            )
        if not self.train_input_dirs:
            errors.append("--train-input-dirs is required")
        if not self.output_dir:
            errors.append("--output-dir is required")
        if not self.updating_sequence:
            errors.append("--updating-sequence is required")
        known = (set(self.fixed_effect_data_configs) | set(self.random_effect_data_configs)
                 | set(self.factored_configs))
        for name in self.updating_sequence:
            if name not in known:
                errors.append(f"coordinate {name!r} has no data configuration")
        if self.num_iterations < 1:
            errors.append("--num-iterations must be >= 1")
        if self.train_date_range and self.train_date_range_days_ago:
            errors.append("--train-date-range and --train-date-range-days-ago are exclusive")
        if self.validate_date_range and self.validate_date_range_days_ago:
            errors.append(
                "--validate-date-range and --validate-date-range-days-ago are exclusive")
        errors.extend(_io_errors(self))
        if self.io_retry_base_delay < 0:
            errors.append("--io-retry-base-delay must be >= 0")
        try:
            from photon_ml_tpu_torch.serve.quantize import validate_store_dtype

            validate_store_dtype(self.store_dtype)
        except ValueError as e:
            errors.append(f"--store-dtype: {e}")
        if self.divergence_guard not in ("off", "rollback", "skip_cycle"):
            errors.append(
                "--divergence-guard must be 'off', 'rollback', or "
                f"'skip_cycle', got {self.divergence_guard!r}"
            )
        if self.max_restarts < 0:
            errors.append("--max-restarts must be >= 0")
        if self.checkpoint_async and not self.checkpoint_dir:
            errors.append("--checkpoint-async needs --checkpoint-dir")
        if self.device not in ("cuda", "cpu"):
            errors.append(f"--device must be cuda or cpu, got {self.device!r}")
        # the schedule flags are checked through the execution plan, as the
        # JAX parser does: a broken spec is reported and normalized to "off"
        # so the plan's own fences still run
        ladder_spec = self.shape_canonicalization
        try:
            from photon_ml_tpu_torch.compile import resolve_bucketer

            resolve_bucketer(ladder_spec)
        except ValueError as e:
            errors.append(f"--shape-canonicalization: {e}")
            ladder_spec = "off"
        compaction_spec = self.solve_compaction
        try:
            from photon_ml_tpu_torch.optim.scheduler import resolve_schedule

            resolve_schedule(compaction_spec)
        except ValueError as e:
            errors.append(f"--solve-compaction: {e}")
            compaction_spec = "off"
        adaptive_spec = self.adaptive_schedule
        try:
            from photon_ml_tpu_torch.optim.convergence import resolve_adaptive

            resolve_adaptive(adaptive_spec)
        except ValueError as e:
            errors.append(f"--adaptive-schedule: {e}")
            adaptive_spec = "off"
        plan_spec = self.plan
        try:
            from photon_ml_tpu_torch.compile.overrides import resolve_plan_mode

            resolve_plan_mode(plan_spec)
        except ValueError as e:
            errors.append(str(e))
            plan_spec = "off"
        try:
            from photon_ml_tpu_torch.compile.plan import ExecutionPlan

            ExecutionPlan.resolve(
                shape_canonicalization=ladder_spec, solve_compaction=compaction_spec,
                adaptive_schedule=adaptive_spec, bucketed=self.bucketed_random_effects,
                vmapped_grid=self.vmapped_grid, streaming=self.streaming_random_effects,
                plan=plan_spec)
        except ValueError as e:
            errors.append(str(e))
        if self.warm_start_from and (os.path.abspath(self.warm_start_from)
                                     == os.path.abspath(self.output_dir)):
            errors.append(
                "--warm-start-from must point at a PRIOR run's output "
                "dir, not this run's --output-dir (preparing the "
                "output dir would destroy the prior model the warm "
                "start reads)"
            )
        errors.extend(f"{flag} is not yet ported to photon_ml_tpu_torch"
                      for flag in self.unported_flags)
        if errors:
            raise ValueError("; ".join(errors))

    def config_grid(self) -> List[Dict[str, CoordinateOptConfig]]:
        """Cartesian product over the fixed/random grids, merged per combo
        (cli/game/training/Driver.scala:330-337 grid semantics)."""
        combos = []
        for fe, re in itertools.product(self.fixed_effect_opt_grid, self.random_effect_opt_grid):
            merged = dict(fe)
            merged.update(re)
            combos.append(merged)
        return combos


def _io_errors(params) -> List[str]:
    """The checks of the resilience flags both drivers take."""
    errors = []
    if params.on_corrupt not in ("raise", "skip"):
        errors.append(f"--on-corrupt must be 'raise' or 'skip', got {params.on_corrupt!r}")
    if params.corrupt_skip_budget < 0:
        errors.append("--corrupt-skip-budget must be >= 0")
    if params.io_retries < 1:
        errors.append("--io-retries must be >= 1")
    return errors


# flag -> its default; a parsed value other than the default (or an "off"
# spelling) names the flag in validate's "not yet ported" error
_FENCED = {
    "--distributed": "false",
    "--fused-cycle": "false",
    "--persistent-cache": None,
}
# values that leave a fenced flag unset, besides its default
_UNSET = ("", "none", "off", "false", "0", "no")


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def build_training_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch game-training",
        description="GAME (GLMix) training driver on the card",
    )
    a = p.add_argument
    a("--train-input-dirs", required=True, help="comma-separated input dirs")
    a("--task-type", required=True, choices=[t.value for t in TaskType])
    a("--output-dir", required=True)
    a("--updating-sequence", required=True, help="comma-separated coordinate names")
    a("--validate-input-dirs", default=None)
    a("--train-date-range", default=None, help="yyyyMMdd-yyyyMMdd")
    a("--train-date-range-days-ago", default=None, help="e.g. 90-1")
    a("--validate-date-range", default=None)
    a("--validate-date-range-days-ago", default=None)
    a("--feature-shard-id-to-feature-section-keys-map", dest="shard_sections", default=None)
    a("--feature-shard-id-to-intercept-map", dest="shard_intercepts", default=None)
    a("--feature-name-and-term-set-path", dest="name_and_term_path", default=None,
      help="deprecated NameAndTerm vocabulary dir (one text subdir per section); "
           "replaces the whole-dataset feature scan")
    a("--num-iterations", type=int, default=1)
    a("--fixed-effect-optimization-configurations", dest="fe_opt", default=None)
    a("--random-effect-optimization-configurations", dest="re_opt", default=None)
    a("--fixed-effect-data-configurations", dest="fe_data", default=None)
    a("--random-effect-data-configurations", dest="re_data", default=None)
    a("--factored-random-effect-optimization-configurations", dest="factored_opt", default=None)
    a("--compute-variance", default="false")
    a("--model-output-mode", default="BEST", choices=[m.value for m in ModelOutputMode])
    a("--num-output-files-for-random-effect-model", dest="num_re_files", type=int, default=1)
    a("--delete-output-dir-if-exists", default="false")
    a("--application-name", default="photon-ml-tpu-game")
    a("--offheap-indexmap-dir", default=None,
      help="feature maps written by feature_indexing (JSON or OFFHEAP)")
    a("--evaluator-type", dest="evaluators", default=None)
    # Spark partitioning knobs, accepted for command compatibility and ignored
    # (the store's partition count is in its own meta.json)
    a("--min-partitions-for-validation", type=int, default=1)
    a("--offheap-indexmap-num-partitions", type=int, default=1)
    _add_io_flags(a)
    a("--io-retry-base-delay", type=float, default=0.05,
      help="base backoff delay in seconds between I/O retries")
    a("--checkpoint-dir", default=None,
      help="step checkpoints after every coordinate update; a rerun resumes "
           "from the latest intact step")
    a("--checkpoint-async", default="false",
      help="commit checkpoints on a background thread through the same "
           "retry/atomic-rename path")
    a("--max-restarts", type=int, default=0,
      help="on a cooperative preemption (SIGTERM/SIGINT or PHOTON_PREEMPT_AT), "
           "relaunch in-process from the latest checkpoint up to N times before "
           "exiting with the preemption exit code (75)")
    a("--divergence-guard", default="off", choices=["off", "rollback", "skip_cycle"],
      help="non-finite gate on coordinate updates: rollback restores the last "
           "good state, skip_cycle also abandons the iteration")
    a("--vmapped-grid", default="false",
      help="train a lambda-only grid through CoordinateDescent.run_grid on "
           "coordinates built once (true|auto); other grids fall back, logged, "
           "to the per-combo rebuild")
    a("--bucketed-random-effects", default="false",
      help="size-bucketed per-entity solves: entities grouped by sample count, "
           "each bucket padded only to its own largest entity")
    a("--streaming-random-effects", default="false",
      help="out-of-core random effects: entity blocks written once to disk "
           "stream through the solve, one block resident (two while the next "
           "one's copy is in flight)")
    a("--re-memory-budget-mb", default=None,
      help="cap the resident random-effect block slab (MB); implies "
           "--streaming-random-effects")
    a("--export-serve-store", dest="export_serve_store", default=None,
      help="after save, export the best model as an mmap'd serving store at "
           "this dir (serve/model_store.py) — the artifact a live scoring "
           "server hot-swaps in")
    a("--store-dtype", default="f32", choices=_store_dtype_choices(),
      help="slab storage policy for --export-serve-store: f32 keeps the "
           "bitwise-to-the-driver contract; bf16/int8 (per-row absmax scales) "
           "halve/quarter the slab bytes under a pinned, export-verified "
           "quantization-error budget")
    a("--tensor-cache", dest="tensor_cache_dir", default=None,
      help="content-addressed on-disk cache of built ingest tensors (keyed by "
           "source file stats + ingest config): warm runs skip the Avro decode, "
           "grouping and padding; any input or config change is a miss")
    a("--shape-canonicalization", default="off",
      help="canonical shape ladder: off | on | BASE:GROWTH (e.g. 8:2); every "
           "bucket's dims round up a geometric ladder with masked padding")
    a("--solve-compaction", default=None,
      help="convergence-compacted random-effect solves: run the lane-batched "
           "per-entity solve in chunks, repacking unconverged lanes into "
           "ladder-sized batches between chunks (bitwise-equal results): "
           "off | on | CHUNK | device[:CHUNK] (the rung loop, one captured CUDA "
           "graph per ladder rung on the card: host reads drop to O(#rungs)). "
           "Default defers to PHOTON_SOLVE_CHUNK; --vmapped-grid true cannot "
           "pause at chunk boundaries")
    a("--adaptive-schedule", default=None,
      help="adaptive scheduling for bucketed random effects: skip a bucket "
           "whose gradient-norm score stayed under TOL for K consecutive "
           "epochs (coefficients carried forward bitwise, every skip a recorded "
           "plan decision): off | on | TOL | TOL:K (e.g. 1e-5:2). Default defers "
           "to PHOTON_ADAPTIVE_SCHEDULE; the ledger lands in retrain.json; "
           "pinned to always-visit without --bucketed-random-effects, fenced "
           "with --vmapped-grid true")
    a("--warm-start-from", dest="warm_start_from", default=None,
      help="prior run's output dir (holds retrain.json + the saved "
           "model): delta retraining — unchanged coordinates/entity "
           "blocks skip their solves bitwise, dirty work re-solves "
           "warm-started from the prior model, an all-unchanged rerun "
           "reuses the prior model wholesale; a missing/corrupt prior "
           "degrades to a recorded cold run")
    a("--plan", default=None,
      help="cost-based query planner: off | auto. Under auto, knobs left "
           "unset (shape ladder, solve-chunk size, sparse family, "
           "prefetch depth, blocking) are chosen by the cost model "
           "(compile/cost.py) from workload statistics, corrected by the "
           "realized-cost feedback persisted in the cost-model.json "
           "sidecar beside retrain.json; every choice is a recorded "
           "PlanDecision with predicted AND realized cost. Explicit flags "
           "and env knobs always win over the planner. Default defers to "
           "PHOTON_PLAN (off = today's behavior, bitwise)")
    for flag, default in _FENCED.items():
        kind = type(default) if isinstance(default, (int, float)) else None
        a(flag, dest=_dest(flag), default=default, type=kind,
          help="not yet ported to photon_ml_tpu_torch")
    a("--device", dest="device", default="cuda", choices=["cuda", "cpu"],
      help="where tensors live and the solve runs (default cuda; cuda without "
           "a card raises)")
    return p


def _add_io_flags(a) -> None:
    a("--on-corrupt", default="raise", choices=["raise", "skip"],
      help="corrupt Avro block policy: fail fast, or skip bad blocks "
           "(resyncing on the sync marker) within --corrupt-skip-budget")
    a("--corrupt-skip-budget", type=int, default=16,
      help="max corrupt blocks skipped per part file before raising")
    a("--io-retries", type=int, default=4,
      help="attempts for every filesystem read (exponential backoff)")


def _store_dtype_choices() -> List[str]:
    """The --store-dtype choices (imported lazily: the serve package
    imports the drivers)."""
    from photon_ml_tpu_torch.serve.quantize import STORE_DTYPES

    return list(STORE_DTYPES)


def _truthy(v) -> bool:
    return str(v).strip().lower() in ("true", "1", "yes")


def _unported(ns: argparse.Namespace) -> List[str]:
    return [flag for flag, default in _FENCED.items()
            if str(getattr(ns, _dest(flag))).strip().lower() not in _UNSET + (str(default).lower(),)]


def parse_training_params(argv: Optional[List[str]] = None) -> GameTrainingParams:
    ns = build_training_parser().parse_args(argv)
    params = GameTrainingParams(
        train_input_dirs=[d for d in ns.train_input_dirs.split(",") if d],
        task_type=TaskType(ns.task_type),
        output_dir=ns.output_dir,
        updating_sequence=[c.strip() for c in ns.updating_sequence.split(",") if c.strip()],
        validate_input_dirs=(
            [d for d in ns.validate_input_dirs.split(",") if d] if ns.validate_input_dirs else None
        ),
        train_date_range=ns.train_date_range,
        train_date_range_days_ago=ns.train_date_range_days_ago,
        validate_date_range=ns.validate_date_range,
        validate_date_range_days_ago=ns.validate_date_range_days_ago,
        feature_shard_sections=parse_shard_sections(ns.shard_sections),
        feature_shard_intercepts=parse_shard_intercepts(ns.shard_intercepts),
        feature_name_and_term_set_path=ns.name_and_term_path,
        num_iterations=ns.num_iterations,
        fixed_effect_opt_grid=parse_coordinate_config_grid(ns.fe_opt),
        random_effect_opt_grid=parse_coordinate_config_grid(ns.re_opt),
        fixed_effect_data_configs=parse_fixed_effect_data_configs(ns.fe_data),
        random_effect_data_configs=parse_random_effect_data_configs(ns.re_data),
        factored_configs=parse_factored_config_map(ns.factored_opt),
        compute_variance=_truthy(ns.compute_variance),
        model_output_mode=ModelOutputMode(ns.model_output_mode),
        num_output_files_re_model=ns.num_re_files,
        delete_output_dir_if_exists=_truthy(ns.delete_output_dir_if_exists),
        application_name=ns.application_name,
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        evaluators=parse_evaluators(ns.evaluators),
        on_corrupt=ns.on_corrupt,
        corrupt_skip_budget=ns.corrupt_skip_budget,
        io_retries=ns.io_retries,
        io_retry_base_delay=ns.io_retry_base_delay,
        checkpoint_dir=ns.checkpoint_dir,
        checkpoint_async=_truthy(ns.checkpoint_async),
        max_restarts=ns.max_restarts,
        divergence_guard=ns.divergence_guard,
        vmapped_grid=("auto" if str(ns.vmapped_grid).lower() == "auto"
                      else "true" if _truthy(ns.vmapped_grid) else "false"),
        bucketed_random_effects=_truthy(ns.bucketed_random_effects),
        streaming_random_effects=(_truthy(ns.streaming_random_effects)
                                  or ns.re_memory_budget_mb is not None),
        re_memory_budget_mb=(float(ns.re_memory_budget_mb)
                             if ns.re_memory_budget_mb is not None else None),
        tensor_cache_dir=ns.tensor_cache_dir,
        export_serve_store=ns.export_serve_store,
        store_dtype=ns.store_dtype,
        shape_canonicalization=ns.shape_canonicalization,
        solve_compaction=ns.solve_compaction,
        adaptive_schedule=ns.adaptive_schedule,
        warm_start_from=ns.warm_start_from,
        plan=ns.plan,
        unported_flags=_unported(ns),
        device=ns.device,
    )
    params.validate()
    return params


@dataclasses.dataclass
class GameScoringParams:
    """cli/game/scoring/Params.scala parity."""

    input_dirs: List[str] = dataclasses.field(default_factory=list)
    game_model_input_dir: str = ""
    output_dir: str = ""
    game_model_id: str = ""
    date_range: Optional[str] = None
    date_range_days_ago: Optional[str] = None
    random_effect_id_types: List[str] = dataclasses.field(default_factory=list)
    feature_shard_sections: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    feature_shard_intercepts: Dict[str, bool] = dataclasses.field(default_factory=dict)
    num_output_files_for_scores: int = 1
    delete_output_dir_if_exists: bool = False
    application_name: str = "photon-ml-tpu-game-scoring"
    offheap_indexmap_dir: Optional[str] = None
    evaluators: List[Tuple[EvaluatorType, Optional[int], Optional[str]]] = dataclasses.field(
        default_factory=list
    )
    host_scoring: bool = False  # the numpy path, the device path's parity oracle
    on_corrupt: str = "raise"
    corrupt_skip_budget: int = 16
    io_retries: int = 4
    # where scoring runs: "cuda" (default) or "cpu"
    device: str = "cuda"

    def validate(self) -> None:
        errors = []
        if not self.input_dirs:
            errors.append("--input-dirs is required")
        if not self.game_model_input_dir:
            errors.append("--game-model-input-dir is required")
        if not self.output_dir:
            errors.append("--output-dir is required")
        if self.date_range and self.date_range_days_ago:
            errors.append("--date-range and --date-range-days-ago are exclusive")
        errors.extend(_io_errors(self))
        if self.device not in ("cuda", "cpu"):
            errors.append(f"--device must be cuda or cpu, got {self.device!r}")
        if errors:
            raise ValueError("; ".join(errors))


def build_scoring_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch game-scoring", description="GAME scoring driver on the card"
    )
    a = p.add_argument
    a("--input-dirs", required=True)
    a("--game-model-input-dir", required=True)
    a("--output-dir", required=True)
    a("--game-model-id", default="")
    a("--date-range", default=None, help="yyyyMMdd-yyyyMMdd")
    a("--date-range-days-ago", default=None, help="e.g. 90-1")
    a("--random-effect-id-set", dest="re_id_set", default=None)
    a("--feature-shard-id-to-feature-section-keys-map", dest="shard_sections", default=None)
    a("--feature-shard-id-to-intercept-map", dest="shard_intercepts", default=None)
    a("--num-output-files-for-scores", type=int, default=1)
    a("--delete-output-dir-if-exists", default="false")
    a("--application-name", default="photon-ml-tpu-game-scoring")
    a("--offheap-indexmap-dir", default=None)
    a("--evaluator-type", dest="evaluators", default=None)
    # Spark partitioning knobs, accepted for command compatibility and ignored
    a("--offheap-indexmap-num-partitions", type=int, default=1)
    a("--min-partitions-for-random-effect-model", type=int, default=1)
    a("--host-scoring", default="false",
      help="score with numpy on the host (the device path's parity oracle)")
    _add_io_flags(a)
    a("--device", dest="device", default="cuda", choices=["cuda", "cpu"],
      help="where scoring runs (default cuda; cuda without a card raises)")
    return p


def parse_scoring_params(argv: Optional[List[str]] = None) -> GameScoringParams:
    ns = build_scoring_parser().parse_args(argv)
    params = GameScoringParams(
        input_dirs=[d for d in ns.input_dirs.split(",") if d],
        game_model_input_dir=ns.game_model_input_dir,
        output_dir=ns.output_dir,
        game_model_id=ns.game_model_id,
        date_range=ns.date_range,
        date_range_days_ago=ns.date_range_days_ago,
        random_effect_id_types=(
            [t.strip() for t in ns.re_id_set.split(",") if t.strip()] if ns.re_id_set else []
        ),
        feature_shard_sections=parse_shard_sections(ns.shard_sections),
        feature_shard_intercepts=parse_shard_intercepts(ns.shard_intercepts),
        num_output_files_for_scores=ns.num_output_files_for_scores,
        delete_output_dir_if_exists=_truthy(ns.delete_output_dir_if_exists),
        application_name=ns.application_name,
        offheap_indexmap_dir=ns.offheap_indexmap_dir,
        evaluators=parse_evaluators(ns.evaluators),
        host_scoring=_truthy(ns.host_scoring),
        on_corrupt=ns.on_corrupt,
        corrupt_skip_budget=ns.corrupt_skip_budget,
        io_retries=ns.io_retries,
        device=ns.device,
    )
    params.validate()
    return params


@dataclasses.dataclass
class GameServeParams:
    """Online scoring server parameters (photon_ml_tpu_torch.serve; the JAX
    package's GameServeParams with ``device``)."""

    # model source: a prebuilt serve store, or a saved GAME model dir the
    # driver exports into one at --model-store-dir first
    model_store_dir: str = ""
    game_model_input_dir: Optional[str] = None
    feature_shard_sections: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    # micro-batching (serve/batcher.py): coalesce concurrent requests up to
    # this many rows / this long a wait onto one ladder-canonical batch
    max_batch_rows: int = 128
    max_wait_ms: float = 2.0
    # canonical shape ladder — defaults ON for serving
    shape_canonicalization: str = "on"
    # the JAX server's persistent XLA cache; the port has no counterpart
    # (the command line fences it, the driver warns on it)
    persistent_cache_dir: Optional[str] = None
    # warmup: score every (rows, nnz) ladder rung at startup; nnz cap per
    # shard for the warmed rungs
    warmup: bool = True
    warm_nnz: Optional[int] = None
    # fail startup unless the start compiled nothing new (needs the cache)
    assert_warm: bool = False
    # export the model store from --game-model-input-dir then exit
    build_store_only: bool = False
    num_store_partitions: int = 1
    # slab storage policy when THIS driver exports the store
    store_dtype: str = "f32"
    log_path: Optional[str] = None
    # flags given away from their default whose code paths are not yet
    # ported (filled by the parser; validate refuses them)
    unported_flags: List[str] = dataclasses.field(default_factory=list)
    # where the server scores: "cuda" (default) or "cpu"
    device: str = "cuda"

    def validate(self) -> None:
        errors = []
        if not self.model_store_dir:
            errors.append("--model-store-dir is required")
        try:
            from photon_ml_tpu_torch.serve.quantize import validate_store_dtype

            validate_store_dtype(self.store_dtype)
        except ValueError as e:
            errors.append(f"--store-dtype: {e}")
        if self.build_store_only and not self.game_model_input_dir:
            errors.append("--build-store-only needs --game-model-input-dir")
        if self.max_batch_rows < 1:
            errors.append("--max-batch-rows must be >= 1")
        if self.max_wait_ms < 0:
            errors.append("--max-wait-ms must be >= 0")
        if self.num_store_partitions < 1:
            errors.append("--num-store-partitions must be >= 1")
        if self.warm_nnz is not None and self.warm_nnz < 1:
            errors.append("--warm-nnz must be >= 1")
        if self.assert_warm and not self.persistent_cache_dir:
            errors.append(
                "--assert-warm needs --persistent-cache (zero new compiles "
                "is only achievable from a filled persistent cache)"
            )
        if self.assert_warm and not self.warmup:
            errors.append(
                "--assert-warm needs warmup: with --no-warmup nothing "
                "compiles at startup, so 'zero new compiles' would hold "
                "vacuously while every first request pays a compile"
            )
        try:
            from photon_ml_tpu_torch.compile import resolve_bucketer

            resolve_bucketer(self.shape_canonicalization)
        except ValueError as e:
            errors.append(f"--shape-canonicalization: {e}")
        if self.device not in ("cuda", "cpu"):
            errors.append(f"--device must be cuda or cpu, got {self.device!r}")
        errors.extend(f"{flag} is not yet ported to photon_ml_tpu_torch"
                      for flag in self.unported_flags)
        if errors:
            raise ValueError("; ".join(errors))


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon-ml-tpu-torch game-serve",
        description="persistent online GAME scoring server on the card (JSON-lines "
        "on stdin/stdout; photon_ml_tpu_torch.serve)",
    )
    a = p.add_argument
    a("--model-store-dir", required=True,
      help="mmap'd serving store (serve/model_store.py layout); built here "
           "from --game-model-input-dir when absent")
    a("--game-model-input-dir", default=None,
      help="saved GAME model dir (reference Avro layout) to export into "
           "the store when the store does not exist yet")
    a("--feature-shard-id-to-feature-section-keys-map", dest="shard_sections",
      default=None)
    a("--max-batch-rows", type=int, default=128,
      help="micro-batch row cap: concurrent requests coalesce up to this "
           "many rows per device call")
    a("--max-wait-ms", type=float, default=2.0,
      help="micro-batch window: the first request of an idle window waits "
           "at most this long for company (a saturated queue never waits)")
    a("--shape-canonicalization", default="on",
      help="batch-shape ladder: off | on | BASE:GROWTH (default ON — every "
           "request shape rounds up to a warmed canonical shape)")
    a("--persistent-cache", dest="persistent_cache_dir", default=None,
      help="not yet ported to photon_ml_tpu_torch")
    a("--no-warmup", action="store_true",
      help="skip the startup ladder warmup")
    a("--warm-nnz", type=int, default=None,
      help="nnz-per-row cap the warmup assumes (default 64, clamped to the "
           "feature dim)")
    a("--assert-warm", default="false",
      help="fail startup unless zero new compiles after warmup (needs the "
           "persistent cache, which the port does not have)")
    a("--build-store-only", default="false",
      help="export --game-model-input-dir into --model-store-dir, then exit")
    a("--num-store-partitions", type=int, default=1,
      help="pmix partitions for the store's feature/entity lookups")
    a("--store-dtype", default="f32", choices=_store_dtype_choices(),
      help="slab storage policy when exporting the store here: f32 "
           "(bitwise default) | bf16 | int8 with per-row absmax scales, "
           "under a pinned export-verified quantization-error budget")
    a("--log-path", default=None, help="log file (default: stderr only)")
    a("--device", dest="device", default="cuda", choices=["cuda", "cpu"],
      help="where the server scores (default cuda; cuda without a card raises)")
    return p


def parse_serve_params(argv: Optional[List[str]] = None) -> GameServeParams:
    ns = build_serve_parser().parse_args(argv)
    params = GameServeParams(
        model_store_dir=ns.model_store_dir,
        game_model_input_dir=ns.game_model_input_dir,
        feature_shard_sections=parse_shard_sections(ns.shard_sections),
        max_batch_rows=ns.max_batch_rows,
        max_wait_ms=ns.max_wait_ms,
        shape_canonicalization=ns.shape_canonicalization,
        persistent_cache_dir=ns.persistent_cache_dir,
        warmup=not ns.no_warmup,
        warm_nnz=ns.warm_nnz,
        assert_warm=_truthy(ns.assert_warm),
        build_store_only=_truthy(ns.build_store_only),
        num_store_partitions=ns.num_store_partitions,
        store_dtype=ns.store_dtype,
        log_path=ns.log_path,
        unported_flags=(["--persistent-cache"]
                        if str(ns.persistent_cache_dir or "").strip().lower() not in _UNSET
                        else []),
        device=ns.device,
    )
    params.validate()
    return params
