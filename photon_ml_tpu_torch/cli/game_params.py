"""GAME training parameters: delimited-string configs and the command-line
parser (port of the training half of photon_ml_tpu/cli/game_params.py).

Reference spec: cli/game/training/Params.scala:196-395 and its config
grammars:

  per-coordinate optimization config (GLMOptimizationConfiguration.scala:41-75):
      maxIter,tol,regWeight,downSamplingRate,optimizer,regType
  coordinate map: "name:cfg|name2:cfg2"
  fixed-effect data config: "name:shardId,minPartitions"
  random-effect data config (RandomEffectDataConfiguration.scala:60-124):
      "name:reId,shardId,numPartitions,activeUB,passiveLB,featureRatio,projector"
  feature shard map: "shard1:sec1,sec2|shard2:sec3"

The parser takes every flag of the JAX driver under the same name, plus
``--device`` (default ``cuda``). ``validate`` rejects, naming the flag, every
flag whose code path is not yet ported when it is set away from its default:
checkpoints, the lambda grid (';'-separated alternatives), factored
coordinates, bucketed/streaming random effects, solve compaction, the fused
cycle, the mesh, the caches, warm starts, the planner, RANDOM projection,
feature selection, down-sampling and the rest listed in ``_FENCED``.
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
    feature_shard_sections: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    feature_shard_intercepts: Dict[str, bool] = dataclasses.field(default_factory=dict)
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
    evaluators: List[Tuple[EvaluatorType, Optional[int], Optional[str]]] = dataclasses.field(
        default_factory=list
    )
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
            if cfg.projector not in ("INDEX_MAP", "IDENTITY"):
                flags.append(f"{cfg.projector} projection (coordinate {name!r})")
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


# flag -> its default; a parsed value other than the default (or an "off"
# spelling) names the flag in validate's "not yet ported" error
_FENCED = {
    "--train-date-range": None,
    "--train-date-range-days-ago": None,
    "--validate-date-range": None,
    "--validate-date-range-days-ago": None,
    "--feature-name-and-term-set-path": None,
    "--factored-random-effect-optimization-configurations": None,
    "--offheap-indexmap-dir": None,
    "--offheap-indexmap-num-partitions": 1,
    "--checkpoint-dir": None,
    "--checkpoint-async": "false",
    "--max-restarts": 0,
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
    "--on-corrupt": "raise",
    "--corrupt-skip-budget": 16,
    "--io-retries": 4,
    "--io-retry-base-delay": 0.05,
    "--divergence-guard": "off",
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
    a("--feature-shard-id-to-feature-section-keys-map", dest="shard_sections", default=None)
    a("--feature-shard-id-to-intercept-map", dest="shard_intercepts", default=None)
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
    a("--evaluator-type", dest="evaluators", default=None)
    # a Spark partitioning knob, accepted for command compatibility and ignored
    a("--min-partitions-for-validation", type=int, default=1)
    for flag, default in _FENCED.items():
        kind = type(default) if isinstance(default, (int, float)) else None
        a(flag, dest=_dest(flag), default=default, type=kind,
          help="not yet ported to photon_ml_tpu_torch")
    a("--device", dest="device", default="cuda", choices=["cuda", "cpu"],
      help="where tensors live and the solve runs (default cuda; cuda without "
           "a card raises)")
    return p


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
        feature_shard_sections=parse_shard_sections(ns.shard_sections),
        feature_shard_intercepts=parse_shard_intercepts(ns.shard_intercepts),
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
        evaluators=parse_evaluators(ns.evaluators),
        unported_flags=_unported(ns),
        device=ns.device,
    )
    params.validate()
    return params
