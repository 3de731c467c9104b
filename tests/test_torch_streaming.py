"""The port's chunk-streamed GLM training (photon_ml_tpu_torch/optim/
streaming.py, ``training.train_glm_grid_streaming``, the GLM driver's
``--streaming-chunk-rows``) against the JAX package on the same chunks
(CPU):

  * the streamed value+gradient, Hessian-vector and Hessian-diagonal
    passes and ``streaming_summarize`` at ``elementwise``, and the ladder's
    ``pad_glm_chunk`` byte-equal;
  * LBFGS, OWL-QN and TRON grids (with box constraints, and Poisson with
    offsets) at ``solver``; the streaming fixed-effect coordinate too;
  * a pipelined pass and grid bitwise equal to the synchronous ones;
  * the GLM driver with ``--streaming-chunk-rows`` (and
    ``--shape-canonicalization``) against the JAX driver's models at
    ``solver``, and a warm ``--tensor-cache`` run that never calls the
    Avro row decoder and writes the cold run's bytes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm.streaming_fixed_effect import (
    StreamingFixedEffectCoordinate as JStreamingFE,
)
from photon_ml_tpu.cli import glm_driver as jdriver
from photon_ml_tpu.compile.canonical import ShapeBucketer as JBucketer
from photon_ml_tpu.compile.canonical import pad_glm_chunk as j_pad
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.ops.regularization import RegularizationContext as JReg
from photon_ml_tpu.optim import streaming as jstream
from photon_ml_tpu.optim.common import OptimizerConfig as JConfig
from photon_ml_tpu.optim.constraints import BoxConstraints as JBox
from photon_ml_tpu.optim.problem import GLMOptimizationProblem as JProblem
from photon_ml_tpu.training import train_glm_grid_streaming as j_grid
from photon_ml_tpu.types import OptimizerType as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch import training as ttraining
from photon_ml_tpu_torch.algorithm.streaming_fixed_effect import StreamingFixedEffectCoordinate
from photon_ml_tpu_torch.cli import glm_driver as tdriver
from photon_ml_tpu_torch.compile.canonical import ShapeBucketer, pad_glm_chunk
from photon_ml_tpu_torch.io import avro_data
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.ops.regularization import RegularizationContext
from photon_ml_tpu_torch.optim import streaming as tstream
from photon_ml_tpu_torch.optim.common import OptimizerConfig
from photon_ml_tpu_torch.optim.constraints import BoxConstraints
from photon_ml_tpu_torch.optim.problem import GLMOptimizationProblem
from photon_ml_tpu_torch.types import OptimizerType, TaskType
from test_torch_glm_driver import AVRO_FLAGS, _argv as glm_argv, _io, avro_dirs  # noqa: F401
from test_torch_glm_driver import _assert_same_models, _write_libsvm
from tolerances import assert_allclose

N, D, CHUNK = 500, 12, 64


def _data(task, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x[:, -1] = 1.0
    w = (rng.normal(size=D) * 0.3).astype(np.float32)
    z = x @ w
    off = (rng.normal(size=N) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=N).astype(np.float32)
    wt[::17] = 0.0
    if task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(z + off)).astype(np.float32)
    elif task == "LINEAR_REGRESSION":
        y = (z + rng.normal(size=N)).astype(np.float32)
    else:
        y = (rng.random(N) < 1 / (1 + np.exp(-z - off))).astype(np.float32)
    return x, y, off, wt


def _sources(task, tmp_path, chunk=CHUNK):
    x, y, off, wt = _data(task)
    tstream.write_chunk_files(str(tmp_path / "chunks"), x, y, chunk, off, wt)
    return (tstream.ChunkedGLMSource.from_chunk_dir(str(tmp_path / "chunks")),
            jstream.ChunkedGLMSource.from_chunk_dir(str(tmp_path / "chunks")))


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION",
                                  "LINEAR_REGRESSION"])
def test_streamed_passes_match_jax_and_in_memory(task, tmp_path):
    ts, js = _sources(task, tmp_path)
    assert (ts.num_rows, ts.dim, len(ts.loaders)) == (N, D, 8)
    tobj, jobj = GLMObjective(tlosses.for_task(TaskType[task])), \
        JObjective(jlosses.for_task(JTask[task]))
    tvg = tstream.make_streaming_value_and_grad(ts, tobj, NormalizationContext.identity(),
                                                device="cpu")
    jvg = jstream.make_streaming_value_and_grad(js, jobj, JNorm.identity())
    thvp = tstream.make_streaming_hvp(ts, tobj, NormalizationContext.identity(), device="cpu")
    jhvp = jstream.make_streaming_hvp(js, jobj, JNorm.identity())
    rng = np.random.default_rng(1)
    w = (rng.normal(size=D) * 0.2).astype(np.float32)
    v = rng.normal(size=D).astype(np.float32)
    f, g = tvg(torch.from_numpy(w), l2_weight=0.7)
    jf, jg = jvg(jnp.asarray(w), l2_weight=0.7)
    assert_allclose(float(f), float(jf), kind="elementwise", dtype=np.float32)
    assert_allclose(g.numpy(), np.asarray(jg), kind="elementwise")
    hv = thvp(torch.from_numpy(w), torch.from_numpy(v), l2_weight=0.7)
    assert_allclose(hv.numpy(), np.asarray(jhvp(jnp.asarray(w), jnp.asarray(v), l2_weight=0.7)),
                    kind="elementwise")
    diag = tstream.streaming_hessian_diagonal(ts, tobj, NormalizationContext.identity(),
                                              torch.from_numpy(w), 0.7)
    jdiag = jstream.streaming_hessian_diagonal(js, jobj, JNorm.identity(), jnp.asarray(w), 0.7)
    assert_allclose(diag.numpy(), np.asarray(jdiag), kind="elementwise")
    # the in-memory objective on the whole batch
    x, y, off, wt = (torch.from_numpy(a) for a in _data(task))
    batch = GLMBatch(DenseFeatures(x), y, off, wt)
    mf, mg = tobj.value_and_grad(torch.from_numpy(w), batch, NormalizationContext.identity(),
                                 0.7)
    assert_allclose(float(f), float(mf), kind="elementwise", dtype=np.float32)
    assert_allclose(g.numpy(), mg.numpy(), kind="elementwise")


def test_summaries_and_ladder_padding_match_jax(tmp_path):
    ts, js = _sources("LOGISTIC_REGRESSION", tmp_path)
    got, want = tstream.streaming_summarize(ts, device="cpu"), jstream.streaming_summarize(js)
    for name in ("mean", "variance", "count", "num_nonzeros", "max", "min", "norm_l1",
                 "norm_l2", "mean_abs"):
        assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                        kind="elementwise", err_msg=name)
    host = tuple(a[:37] for a in _data("LOGISTIC_REGRESSION"))
    for spec in ((8, 2.0), (16, 1.5)):
        tp, jp = pad_glm_chunk(host, ShapeBucketer(*spec)), j_pad(host, JBucketer(*spec))
        for a, b in zip(tp, jp):
            assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()
    assert pad_glm_chunk(host, None) is host
    # a ladder's weight-0 pad rows leave the streamed pass unchanged
    tobj = GLMObjective(tlosses.logistic)
    w = torch.full((D,), 0.1)
    plain = tstream.make_streaming_value_and_grad(ts, tobj, NormalizationContext.identity(),
                                                  device="cpu")(w)
    padded = tstream.make_streaming_value_and_grad(ts, tobj, NormalizationContext.identity(),
                                                   bucketer="48:2", device="cpu")(w)
    assert_allclose(float(padded[0]), float(plain[0]), kind="elementwise", dtype=np.float32)
    assert_allclose(padded[1].numpy(), plain[1].numpy(), kind="elementwise")


GRIDS = [
    ("LOGISTIC_REGRESSION", "LBFGS", "L2", None),
    ("LOGISTIC_REGRESSION", "LBFGS", "L1", None),
    ("LOGISTIC_REGRESSION", "LBFGS", "L2", 0.05),
    ("LOGISTIC_REGRESSION", "TRON", "L2", None),
    ("LOGISTIC_REGRESSION", "TRON", "L2", 0.05),
    ("POISSON_REGRESSION", "TRON", "L2", None),
    ("POISSON_REGRESSION", "LBFGS", "L2", None),
]


def _problems(task, opt, reg, box, dim):
    cfg = dict(max_iterations=40, tolerance=1e-6)
    t_reg = RegularizationContext.l1(1.0) if reg == "L1" else RegularizationContext.l2(1.0)
    j_reg = JReg.l1(1.0) if reg == "L1" else JReg.l2(1.0)
    t_box = j_box = None
    if box is not None:
        lo, hi = np.full(dim, -box, np.float32), np.full(dim, box, np.float32)
        t_box = BoxConstraints(torch.from_numpy(lo), torch.from_numpy(hi))
        j_box = JBox(jnp.asarray(lo), jnp.asarray(hi))
    return (GLMOptimizationProblem(TaskType[task], OptimizerType[opt], OptimizerConfig(**cfg),
                                   t_reg, compute_variance=True, constraints=t_box),
            JProblem(JTask[task], JOpt[opt], JConfig(**cfg), j_reg, compute_variance=True,
                     constraints=j_box))


@pytest.mark.parametrize("task,opt,reg,box", GRIDS,
                         ids=[f"{t[:4]}-{o}-{r}" + ("-box" if b else "") for t, o, r, b in GRIDS])
def test_streaming_grid_matches_jax(task, opt, reg, box, tmp_path):
    ts, js = _sources(task, tmp_path)
    tp, jp = _problems(task, opt, reg, box, D)
    lams = [10.0, 1.0]
    got = ttraining.train_glm_grid_streaming(tp, ts, NormalizationContext.identity(), lams,
                                             device="cpu")
    want = j_grid(jp, js, JNorm.identity(), lams)
    assert got.weights == want.weights == sorted(lams, reverse=True)
    for tm, jm, tr, jr in zip(got.models, want.models, got.results, want.results):
        assert_allclose(float(tr.value), float(jr.value), kind="solver", dtype=np.float32)
        if (int(tr.iterations), int(tr.reason)) == (int(jr.iterations), int(jr.reason)):
            assert_allclose(tm.coefficients.means.numpy(), np.asarray(jm.coefficients.means),
                            kind="solver")
        assert_allclose(tm.coefficients.variances.numpy(),
                        np.asarray(jm.coefficients.variances), kind="solver")
        if box is not None:
            assert float(tm.coefficients.means.abs().max()) <= box + 1e-7


def test_pipelined_is_bitwise_synchronous(tmp_path, monkeypatch):
    ts, _ = _sources("LOGISTIC_REGRESSION", tmp_path)
    tp, _ = _problems("LOGISTIC_REGRESSION", "TRON", "L2", None, D)
    runs = []
    for depth in ("0", "1", "3"):
        monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", depth)
        grid = ttraining.train_glm_grid_streaming(tp, ts, NormalizationContext.identity(),
                                                  [1.0], device="cpu")
        runs.append(grid.models[0].coefficients.means)
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


def test_per_host_factories_are_fenced(tmp_path):
    """The per-host factories, once fenced, now run: at one rank over every
    chunk they are bitwise the single-host streamed passes, and the JAX
    package's per-host passes hold them at ``elementwise``."""
    ts, js = _sources("LOGISTIC_REGRESSION", tmp_path)
    tobj, jobj = GLMObjective(tlosses.logistic), JObjective(jlosses.logistic)
    norm = NormalizationContext.identity()
    owned = list(range(len(ts.loaders)))
    vg = tstream.make_streaming_value_and_grad(ts, tobj, norm, device="cpu")
    hvp = tstream.make_streaming_hvp(ts, tobj, norm, device="cpu")
    pvg = tstream.make_perhost_value_and_grad(ts, owned, len(owned), tobj, norm, None,
                                              device="cpu")
    phvp = tstream.make_perhost_hvp(ts, owned, len(owned), tobj, norm, None, device="cpu")
    jvg = jstream.make_perhost_value_and_grad(js, owned, len(owned), jobj, JNorm.identity(),
                                              None)
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.normal(size=D) * 0.2).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=D).astype(np.float32))
    (f, g), (pf, pg) = vg(w, l2_weight=0.3), pvg(w, l2_weight=0.3)
    assert torch.equal(f, pf) and torch.equal(g, pg)
    assert torch.equal(hvp(w, v, l2_weight=0.3), phvp(w, v, l2_weight=0.3))
    jf, jg = jvg(jnp.asarray(w.numpy()), l2_weight=0.3)
    assert_allclose(float(pf), float(jf), kind="elementwise", dtype=np.float32)
    assert_allclose(pg.numpy(), np.asarray(jg), kind="elementwise")


@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
def test_streaming_fixed_effect_coordinate_matches_jax(opt, tmp_path):
    ts, js = _sources("LOGISTIC_REGRESSION", tmp_path)
    tp, jp = _problems("LOGISTIC_REGRESSION", opt, "L2", None, D)
    tcoord = StreamingFixedEffectCoordinate(ts, tp, device="cpu", bucketer="off")
    jcoord = JStreamingFE(js, jp, bucketer="off")
    resid = (np.random.default_rng(8).normal(size=N) * 0.2).astype(np.float32)
    tw, tres = tcoord.update(torch.from_numpy(resid), tcoord.initial_coefficients())
    jw, jres = jcoord.update(jnp.asarray(resid), jcoord.initial_coefficients())
    assert_allclose(float(tres.value), float(jres.value), kind="solver", dtype=np.float32)
    assert_allclose(tw.numpy(), np.asarray(jw), kind="solver")
    assert_allclose(tcoord.score(tw).numpy(), np.asarray(jcoord.score(jw)), kind="solver")
    assert_allclose(float(tcoord.regularization_term(tw)),
                    float(jcoord.regularization_term(jw)), kind="solver", dtype=np.float32)
    laddered = StreamingFixedEffectCoordinate(ts, tp, device="cpu", bucketer="48:2")
    assert torch.equal(laddered.score(tw), tcoord.score(tw)[: N])


# ---------------------------------------------------------------------------
# the GLM driver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def libsvm_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("glm")
    for name, n, seed in (("train", 300, 1), ("validate", 120, 2)):
        (root / name).mkdir()
        _write_libsvm(root / name / "part-0.txt", n, seed, "LOGISTIC_REGRESSION")
    return root


@pytest.mark.parametrize("extra", [["--optimizer", "LBFGS"], ["--optimizer", "TRON"],
                                   ["--shape-canonicalization", "on"]],
                         ids=["LBFGS", "TRON", "ladder"])
def test_glm_driver_streaming_matches_jax_driver(libsvm_dirs, extra):
    tag = "-".join(extra).replace("-", "")
    flags = ["--streaming-chunk-rows", "64", *extra]
    jd = jdriver.main(glm_argv(libsvm_dirs, "LOGISTIC_REGRESSION", f"jax{tag}", *flags))
    td = tdriver.main(glm_argv(libsvm_dirs, "LOGISTIC_REGRESSION", f"torch{tag}",
                               "--device", "cpu", *flags))
    assert td.streaming_source is not None and td.train_batch is None
    assert len(td.streaming_source.loaders) == 5  # 300 rows in chunks of 64
    _assert_same_models(jd, td, libsvm_dirs / f"jax{tag}", libsvm_dirs / f"torch{tag}")
    # the spilled chunks are removed once training is done
    assert not os.path.exists(libsvm_dirs / f"torch{tag}" / "stream-chunks")


def test_glm_driver_streaming_refusals_match_jax(libsvm_dirs, tmp_path):
    for extra, words in ((["--validate-per-iteration", "true"], "per-iteration"),
                         (["--diagnostic-mode", "TRAIN"], "--diagnostic-mode"),
                         (["--shape-canonicalization", "sideways"], "--shape-canonicalization")):
        argv = glm_argv(libsvm_dirs, "LOGISTIC_REGRESSION", "refused", "--device", "cpu",
                        "--streaming-chunk-rows", "64", *extra)
        with pytest.raises(ValueError, match=words):
            tdriver.main(argv)
    wide = glm_argv(libsvm_dirs, "LOGISTIC_REGRESSION", "wide", "--device", "cpu",
                    "--streaming-chunk-rows", "64")
    wide[wide.index("--feature-dimension") + 1] = "5000"
    with pytest.raises(ValueError, match="spills DENSE chunks"):
        tdriver.main(wide)


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_glm_driver_warm_tensor_cache_never_decodes_rows(avro_dirs, tmp_path, monkeypatch):  # noqa: F811
    flags = AVRO_FLAGS + ["--streaming-chunk-rows", "128", "--tensor-cache",
                          str(tmp_path / "cache"), "--device", "cpu"]
    tdriver.spill_counts.update(files=0, chunks=0)
    cold = tdriver.main(_io(avro_dirs, "cold-cache") + flags)
    assert tdriver.spill_counts == {"files": 2, "chunks": 7}  # 800 rows
    real = avro_data.read_training_examples
    read = []

    def counted(paths, *a, **kw):
        read.append(list(paths))
        return real(paths, *a, **kw)

    monkeypatch.setattr(avro_data, "read_training_examples", counted)
    warm = tdriver.main(_io(avro_dirs, "warm-cache") + flags)
    # only the validation file is decoded; no training chunk is spilled
    assert read == [[str(avro_dirs / "validate" / "part-00000.avro")]]
    assert tdriver.spill_counts == {"files": 2, "chunks": 7}
    assert [float(r.value) for r in warm.trained.results] == \
        [float(r.value) for r in cold.trained.results]
    for sub in ("output", "best"):
        assert _tree_bytes(avro_dirs / "warm-cache" / sub) == \
            _tree_bytes(avro_dirs / "cold-cache" / sub)
    # the JAX driver keys the same entry: it runs warm on the port's chunks
    jd = jdriver.main(_io(avro_dirs, "jax-warm") + flags[:-2])
    assert_allclose([float(r.value) for r in jd.trained.results],
                    [float(r.value) for r in cold.trained.results], kind="solver",
                    dtype=np.float32)
