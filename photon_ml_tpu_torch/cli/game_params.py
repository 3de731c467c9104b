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

The training parser takes every flag of the JAX driver under the same name,
plus ``--device`` (default ``cuda``). ``validate`` rejects, naming the flag,
every flag whose code path is not yet ported when it is set away from its
default: the lambda grid (';'-separated alternatives), factored
coordinates, bucketed/streaming random effects, solve compaction, the fused
cycle, the mesh, the caches, warm starts, the planner, feature selection,
down-sampling and the rest listed in ``_FENCED``. The scoring parser takes
every flag of the JAX scoring driver, plus ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    # flags of the JAX driver given away from their default whose code paths
    # are not yet ported (filled by the parser; validate refuses them)
    unported_flags: List[str] = dataclasses.field(default_factory=list)
    # where tensors live: "cuda" (default) or "cpu"
    device: str = "cuda"

    def _not_yet_ported(self) -> List[str]:
        flags = list(self.unported_flags)
        if len(self.fixed_effect_opt_grid) > 1 or len(self.random_effect_opt_grid) > 1:
            flags.append("lambda grids (';'-separated optimization configurations)")
        for combo in (self.fixed_effect_opt_grid + self.random_effect_opt_grid):
            for name, cfg in combo.items():
                if cfg.down_sampling_rate < 1.0:
                    flags.append(f"down-sampling rate {cfg.down_sampling_rate} (coordinate {name!r})")
        for name, cfg in self.random_effect_data_configs.items():
            if cfg.features_to_samples_ratio is not None:
                flags.append(f"features-to-samples ratio (coordinate {name!r})")
        return [f"{flag} is not yet ported to photon_ml_tpu_torch" for flag in flags]

    def validate(self) -> None:
        errors = []
        if not self.train_input_dirs:
            errors.append("--train-input-dirs is required")
        if not self.output_dir:
            errors.append("--output-dir is required")
        if not self.updating_sequence:
            errors.append("--updating-sequence is required")
        known = set(self.fixed_effect_data_configs) | set(self.random_effect_data_configs)
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
        errors.extend(self._not_yet_ported())
        if errors:
            raise ValueError("; ".join(errors))

    def opt_configs(self) -> Dict[str, CoordinateOptConfig]:
        """The run's one combination of coordinate configurations (the
        grid of more than one is not yet ported)."""
        merged = dict(self.fixed_effect_opt_grid[0])
        merged.update(self.random_effect_opt_grid[0])
        return merged


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
    "--factored-random-effect-optimization-configurations": None,
    "--distributed": "false",
    "--fused-cycle": "false",
    "--bucketed-random-effects": "false",
    "--streaming-random-effects": "false",
    "--re-memory-budget-mb": None,
    "--tensor-cache": None,
    "--persistent-cache": None,
    "--warm-start-from": None,
    "--export-serve-store": None,
    "--store-dtype": "f32",
    "--shape-canonicalization": "off",
    "--solve-compaction": None,
    "--adaptive-schedule": None,
    "--plan": None,
    "--vmapped-grid": "false",
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
