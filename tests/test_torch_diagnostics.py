"""The port's diagnostics against the JAX package's (CPU), one model and one
batch fed to both from the same numpy inputs: Kendall-tau pair counts and
Hosmer-Lemeshow bins exactly, their statistics at ``elementwise``; feature
importance; the fitting curves and the bootstrap's summaries at ``solver``;
one report tree rendered to the same HTML and text bytes; the Avro report
records equal apart from the timestamps."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.diagnostics import (
    bootstrap_diagnostic as j_boot,
    feature_importance as j_fi,
    fitting as j_fit,
    hosmer_lemeshow as j_hl,
    independence as j_ind,
    reporting as j_rep,
)
from photon_ml_tpu.diagnostics import avro_reports as j_avro
from photon_ml_tpu.io import avro as j_avro_io
from photon_ml_tpu.models.glm import Coefficients as JCoef, GeneralizedLinearModel as JModel
from photon_ml_tpu.ops.features import DenseFeatures as JDense
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMBatch as JBatch
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.ops.stats import summarize as j_summarize
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.types import ConvergenceReason as JReason, OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import bootstrap as t_bootstrap
from photon_ml_tpu_torch.diagnostics import (
    avro_reports as t_avro,
    bootstrap_diagnostic as t_boot,
    feature_importance as t_fi,
    fitting as t_fit,
    hosmer_lemeshow as t_hl,
    independence as t_ind,
    reporting as t_rep,
)
from photon_ml_tpu_torch.io import avro as t_avro_io
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.ops.stats import summarize
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import ConvergenceReason, OptimizerType, TaskType
from tolerances import assert_allclose

D = 6


def _data(n, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    x[:, -1] = 1.0  # intercept column
    w = (rng.normal(size=D) * 0.8).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(x @ w)))).astype(np.float32)
    wt = np.ones(n, np.float32)
    wt[-5:] = 0.0  # padding rows
    return x, y, wt, w


def _batches(x, y, wt):
    n = len(y)
    jb = JBatch(JDense(jnp.asarray(x)), jnp.asarray(y), jnp.zeros(n), jnp.asarray(wt))
    tb = GLMBatch(DenseFeatures(torch.from_numpy(x)), torch.from_numpy(y), torch.zeros(n),
                  torch.from_numpy(wt))
    return jb, tb


def _models(w):
    return (JModel(JCoef(jnp.asarray(w)), JTask.LOGISTIC_REGRESSION),
            GeneralizedLinearModel(Coefficients(torch.from_numpy(w)), TaskType.LOGISTIC_REGRESSION))


def _fields(report, exact):
    return {k: v for k, v in vars(report).items() if (k in exact)}


@pytest.mark.parametrize("n,max_points", [(400, None), (5000, 300)])
def test_kendall_counts_exact_and_statistics(n, max_points):
    rng = np.random.default_rng(n)
    a = rng.normal(size=n).astype(np.float32)
    b = (0.3 * a + rng.normal(size=n)).astype(np.float32)
    b[::7] = b[0]  # ties in b
    j = j_ind.analyze(a, b, max_points=max_points, seed=3)
    t = t_ind.analyze(a, b, max_points=max_points, seed=3)
    exact = ("num_concordant", "num_discordant", "num_samples", "num_pairs",
             "effective_pairs", "message")
    assert _fields(t, exact) == _fields(j, exact)
    for k in ("tau_alpha", "tau_beta", "z_alpha", "p_value"):
        assert_allclose(getattr(t, k), getattr(j, k), kind="elementwise", dtype=np.float64,
                        err_msg=k)


def test_independence_diagnose_on_one_model_and_batch():
    x, y, wt, w = _data(900)
    jb, tb = _batches(x, y, wt)
    jm, tm = _models(w)
    j = j_ind.diagnose(jm, jb).kendall_tau
    t = t_ind.diagnose(tm, tb).kendall_tau
    for k in ("num_concordant", "num_discordant", "num_samples", "num_pairs", "effective_pairs"):
        assert getattr(t, k) == getattr(j, k), k
    for k in ("tau_alpha", "tau_beta", "z_alpha", "p_value"):
        assert_allclose(getattr(t, k), getattr(j, k), kind="elementwise", dtype=np.float32)


@pytest.mark.parametrize("num_bins", [None, 7])
def test_hosmer_lemeshow_bins_exact(num_bins):
    x, y, wt, w = _data(1200)
    jb, tb = _batches(x, y, wt)
    jm, tm = _models(w)
    j = j_hl.diagnose(jm, jb, num_bins=num_bins)
    t = t_hl.diagnose(tm, tb, num_bins=num_bins)
    assert [vars(b) for b in t.histogram] == [vars(b) for b in j.histogram]
    assert (t.binning_msg, t.chi_square_msg, t.degrees_of_freedom) == \
        (j.binning_msg, j.chi_square_msg, j.degrees_of_freedom)
    assert_allclose(t.chi_square, j.chi_square, kind="elementwise", dtype=np.float64)
    assert_allclose(t.chi_square_probability, j.chi_square_probability, kind="elementwise",
                    dtype=np.float64)
    assert t.confidence_cutoffs == j.confidence_cutoffs


def test_bin_scores_on_the_same_scores_are_the_jax_bins():
    rng = np.random.default_rng(5)
    p = rng.random(3001).astype(np.float32)
    p[:10] = [0.0, 1.0, 0.5, 0.25, 0.999999, 1e-9, 0.1, 0.2, 0.3, 0.7]
    y = (rng.random(3001) < p).astype(np.float32)
    wt = (rng.random(3001) > 0.1).astype(np.float32)
    j = j_hl.bin_scores(jnp.asarray(p), jnp.asarray(y), 13, jnp.asarray(wt))
    t = t_hl.bin_scores(torch.from_numpy(p), torch.from_numpy(y), 13, torch.from_numpy(wt))
    assert [vars(b) for b in t] == [vars(b) for b in j]


def test_feature_importance():
    x, y, wt, w = _data(600)
    jb, tb = _batches(x, y, wt)
    jm, tm = _models(w)
    names = [f"f{j}" for j in range(D)]
    for kind in (j_fi.EXPECTED_MAGNITUDE, j_fi.VARIANCE):
        j = j_fi.diagnose(jm, j_summarize(jb), names, importance_type=kind)
        t = t_fi.diagnose(tm, summarize(tb), names, importance_type=kind)
        assert t.importance_description == j.importance_description
        assert [r[:2] for r in t.ranked_features] == [r[:2] for r in j.ranked_features]
        assert_allclose([r[2] for r in t.ranked_features], [r[2] for r in j.ranked_features],
                        kind="elementwise", dtype=np.float32)
        assert sorted(t.rank_to_importance) == sorted(j.rank_to_importance)


def _problems(optimizer="LBFGS", reg=0.5):
    cfg = dict(max_iterations=100, tolerance=1e-7)
    return (JProblem(JTask.LOGISTIC_REGRESSION, JOpt(optimizer), JConfig(**cfg), JReg.l2(reg)),
            GLMOptimizationProblem(TaskType.LOGISTIC_REGRESSION, OptimizerType(optimizer),
                                   OptimizerConfig(**cfg), RegularizationContext.l2(reg)))


def test_partition_tags_are_the_jax_draw():
    import jax

    for n in (13, 6400, 262144):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n,), 0, 10))
        np.testing.assert_array_equal(t_fit.partition_tags(0, n), want)


def test_fitting_curves():
    x, y, wt, _ = _data(6400)  # above the 10 x 10 x D floor
    jb, tb = _batches(x, y, wt)
    jp, tp = _problems()
    lams = [1.0, 0.1]
    j = j_fit.diagnose(jp, jb, JNorm.identity(), lams)
    t = t_fit.diagnose(tp, tb, NormalizationContext.identity(), lams)
    assert sorted(t) == sorted(j) == sorted(lams)
    for lam in lams:
        assert sorted(t[lam].metrics) == sorted(j[lam].metrics)
        for name, (portions, train, test) in j[lam].metrics.items():
            tport, ttrain, ttest = t[lam].metrics[name]
            assert tport == portions  # the same tags: the same prefixes
            assert len(portions) == j_fit.NUM_TRAINING_PARTITIONS - 1
            assert_allclose(ttrain, train, kind="solver", dtype=np.float32, err_msg=name)
            assert_allclose(ttest, test, kind="solver", dtype=np.float32, err_msg=name)


def test_fitting_skips_small_data():
    x, y, wt, _ = _data(500)
    jb, tb = _batches(x, y, wt)
    jp, tp = _problems()
    assert j_fit.diagnose(jp, jb, JNorm.identity(), [1.0]) == {}
    assert t_fit.diagnose(tp, tb, NormalizationContext.identity(), [1.0]) == {}


@pytest.mark.parametrize("optimizer", ["LBFGS", "TRON"])
def test_bootstrap_summaries(optimizer):
    x, y, wt, _ = _data(1500)
    hx, hy, hwt, _ = _data(400, seed=12)
    jb, tb = _batches(x, y, wt)
    jh, th = _batches(hx, hy, hwt)
    jp, tp = _problems(optimizer)
    names = [f"f{j}" for j in range(D)]
    j = j_boot.diagnose(jp, jb, JNorm.identity(), jh, names, num_samples=5)
    t = t_boot.diagnose(tp, tb, NormalizationContext.identity(), th, names, num_samples=5)
    assert sorted(t.metric_distributions) == sorted(j.metric_distributions)
    for k, v in j.metric_distributions.items():
        assert_allclose(t.metric_distributions[k], v, kind="solver", dtype=np.float32, err_msg=k)
    for k, v in j.bagged_model_metrics.items():
        assert_allclose(t.bagged_model_metrics[k], v, kind="solver", dtype=np.float32, err_msg=k)
    assert list(t.important_feature_distributions) == list(j.important_feature_distributions)
    for k, s in j.important_feature_distributions.items():
        assert_allclose([getattr(t.important_feature_distributions[k], f) for f in vars(s)],
                        list(vars(s).values()), kind="solver", dtype=np.float32, err_msg=k)


def test_bootstrap_lanes_are_the_replicates_solved_alone():
    """Each lane of the one k-lane solve is its replicate's solve on its own
    resampled batch: per-lane stopping."""
    x, y, wt, _ = _data(800)
    _, tb = _batches(x, y, wt)
    _, tp = _problems()
    result = t_bootstrap.bootstrap_train(tp, tb, NormalizationContext.identity(), num_samples=3,
                                         metrics_fn=lambda m: {})
    counts = t_bootstrap.bootstrap_weights(0, 3, tb.num_rows)
    for i in range(3):
        alone = GLMBatch(tb.features, tb.labels, tb.offsets, tb.weights * counts[i])
        model, _ = tp.run(alone, NormalizationContext.identity())
        torch.testing.assert_close(result.models[i].coefficients.means,
                                   model.coefficients.means, rtol=0, atol=0)


def _report_tree(rep, kendall):
    """One report with every non-plot leaf kind, built from one package's
    reporting classes, with the independence section of ``kendall``."""
    section = rep.SectionReport("Parameters", [
        rep.TableReport(["Parameter", "Value"], [["task", "LOGISTIC_REGRESSION"], ["λ", 0.1]],
                        caption="Run <params>"),
        rep.SimpleTextReport("a & b"),
        rep.BulletedListReport(["one", "two"]),
        rep.NumberedListReport(["first"]),
        rep.SectionReport("Nested", [rep.SimpleTextReport(f"{math.pi:.6g}")]),
    ])
    return rep.DocumentReport("diagnostics", [
        rep.ChapterReport("System", [section]),
        rep.ChapterReport("Model (lambda = 0.1)", [kendall]),
    ])


def test_render_html_and_text_byte_equal():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=500).astype(np.float32), rng.normal(size=500).astype(np.float32)
    jdoc = _report_tree(j_rep, j_ind.to_section(j_ind.PredictionErrorIndependenceReport(
        j_ind.analyze(a, b))))
    tdoc = _report_tree(t_rep, t_ind.to_section(t_ind.PredictionErrorIndependenceReport(
        t_ind.analyze(a, b))))
    assert t_rep.render_html(tdoc) == j_rep.render_html(jdoc)
    assert t_rep.render_text(tdoc) == j_rep.render_text(jdoc)


def test_plots_render_the_same_bytes_twice():
    plot = t_rep.PlotReport("AUC (lambda=1)", "% of training data", "AUC",
                            {"train": ([10.0, 20.0, 30.0], [0.7, 0.71, float("nan")]),
                             "holdout": ([10.0, 20.0, 30.0], [0.6, 0.65, 0.66])})
    svg = plot.to_svg()
    assert svg == plot.to_svg()
    assert svg.startswith("<svg") and svg.endswith("</svg>")
    assert svg.count("<polyline") == 2 and svg.count("<circle") == 5  # the NaN point is dropped
    doc = t_rep.DocumentReport("d", [t_rep.ChapterReport("c", [t_rep.SectionReport("s", [plot])])])
    assert t_rep.render_html(doc) == t_rep.render_html(doc)
    log = t_rep.PlotReport("t", "x", "y", {"a": ([1.0, 10.0, 100.0], [1.0, 2.0, 3.0])}, log_x=True)
    assert ">100<" in log.to_svg()


def _without_timestamps(rec):
    ctx = dict(rec["evaluationContext"])
    ctx.pop("timestamp")
    ctx.pop("metricsCalculator")
    ctx["modelTrainingContext"] = {k: v for k, v in ctx["modelTrainingContext"].items()
                                   if k != "timestamp"}
    return {**rec, "evaluationContext": ctx}


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def test_avro_report_records(tmp_path, task):
    x, y, wt, w = _data(700)
    jb, tb = _batches(x, y, wt)
    scores = (1.0 / (1.0 + np.exp(-(x @ w)))).astype(np.float32)
    curves = task == "LOGISTIC_REGRESSION"
    common = dict(model_id="m-lambda-1", model_path="out/output", data_path="val",
                  scalar_metrics={"AUC": 0.75, "Peak F1": 0.5}, scores=scores, labels=y,
                  weights=wt, with_curves=curves)
    j = j_avro.evaluation_result(train_ctx=j_avro.training_context(
        JTask(task), 0.0, 1.0, True, "LBFGS", 1e-6, 80, JReason.GRADIENT_CONVERGED, "train"),
        **common)
    t = t_avro.evaluation_result(train_ctx=t_avro.training_context(
        TaskType(task), 0.0, 1.0, True, "LBFGS", 1e-6, 80, ConvergenceReason.GRADIENT_CONVERGED,
        "train"), **common)
    assert _without_timestamps(t) == _without_timestamps(j)
    assert t["evaluationContext"]["metricsCalculator"] == "photon_ml_tpu_torch.evaluation.metrics"
    names = [f"f{j}:t" for j in range(D)]
    jf = j_avro.feature_summaries(names, j_summarize(jb))
    tf = t_avro.feature_summaries(names, summarize(tb))
    assert [(r["featureName"], r["featureTerm"], sorted(r["metrics"])) for r in tf] == \
        [(r["featureName"], r["featureTerm"], sorted(r["metrics"])) for r in jf]
    for a, b in zip(tf, jf):
        assert_allclose(list(a["metrics"].values()), list(b["metrics"].values()),
                        kind="elementwise", dtype=np.float32)
    # each package reads the other's files
    t_path = t_avro.write_evaluation_results(str(tmp_path / "t"), [t])
    j_path = j_avro.write_evaluation_results(str(tmp_path / "j"), [j])
    assert [_without_timestamps(r) for r in j_avro_io.read_container(t_path)] == \
        [_without_timestamps(t)]
    assert [_without_timestamps(r) for r in t_avro_io.read_container(j_path)] == \
        [_without_timestamps(j)]
    t_sum = t_avro.write_feature_summaries(str(tmp_path / "t"), jf)
    j_sum = j_avro.write_feature_summaries(str(tmp_path / "j"), jf)
    assert open(t_sum, "rb").read() == open(j_sum, "rb").read()
