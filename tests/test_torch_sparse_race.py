"""The port's two races (CPU): the per-bucket sparse race of
``ops/fused_sparse.py`` against the JAX package's report, and the dense
fused-kernel race of ``ops/fused_glm.py``.

  * the sparse report has the JAX report's keys, shape and nnz accounting;
  * every raced name is timed or failed with a reason (names that run
    another name's code are timed once, under that name), and an injected
    failure (an error, or a value not bitwise the baseline's) is recorded;
  * the card's plain transpose (``FlatOrderPlan``) is bitwise the CPU's
    flat-order ``index_add_``;
  * every decision is logged, and recorded decisions are adopted;
  * the race cache is keyed by loss, shape, dtype, device and candidates;
  * ``pallas`` is ineligible under float64;
  * ``auto`` through ``build_and_select`` and the random-effect coordinate;
  * the dense race's ``PHOTON_ML_TPU_FUSED`` grammar (``auto|0|1``) and its
    answer on the CPU: always the plain path (``None``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import fused_sparse as jfs
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu_torch.algorithm.random_effect import RandomEffectCoordinate
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops import fused_glm as tfg
from photon_ml_tpu_torch.ops import fused_sparse as tfs
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.types import TaskType

TASK = TaskType.LOGISTIC_REGRESSION


def _skewed_dense(seed, e, m, d, dtype=np.float32):
    """(E, M, D) stacks of skewed row non-zeros, their labels, weights (some
    zero) and offsets."""
    rng = np.random.default_rng(seed)
    keep = rng.random((e, m, d)) < rng.uniform(0.1, 0.6, size=(e, m, 1))
    x = np.where(keep, rng.normal(size=(e, m, d)), 0.0).astype(dtype)
    y = (rng.random((e, m)) < 0.5).astype(np.float32)
    wt = np.where(rng.random((e, m)) < 0.15, 0.0, rng.uniform(0.5, 2.0, (e, m))).astype(np.float32)
    off = (rng.normal(size=(e, m)) * 0.1).astype(np.float32)
    return x, y, wt, off


def _race(x, y, wt, off, **kw):
    t = lambda a: torch.from_numpy(a)
    slab = tfs.build_sparse_slab(t(x))
    return tfs.race_sparse_kernels(TASK, slab, t(x), t(y), t(off), t(wt), **kw)


@pytest.fixture
def clean_cache(monkeypatch):
    monkeypatch.setattr(tfs, "_race_cache", {})
    monkeypatch.setattr(tfs, "_race_reports", {})


def test_report_keys_match_jax():
    x, y, wt, off = _skewed_dense(1, 4, 16, 12)
    cands = ("scatter", "segment")
    want = jfs.race_sparse_kernels(JTask.LOGISTIC_REGRESSION, jfs.build_sparse_slab(x, "off"), x,
                                   jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt),
                                   candidates=cands)
    got = _race(x, y, wt, off, candidates=cands)
    assert sorted(got) == sorted(want) == ["baseline", "candidates", "nnz", "shape", "winner"]
    assert got["baseline"] == want["baseline"] == tfs.SPARSE_BASELINE == jfs.SPARSE_BASELINE
    assert got["shape"] == want["shape"] and got["nnz"] == want["nnz"]
    assert sorted(got["candidates"]) == sorted(want["candidates"]) == ["dense", "scatter",
                                                                       "segment"]
    for name in ("dense", "segment"):
        assert sorted(got["candidates"][name]) == sorted(want["candidates"][name]), name
    # scatter runs segment's code in the port: timed once, under segment
    assert got["candidates"]["scatter"] == {
        "failed": "skipped: the port runs it as segment, timed once"}
    assert sorted(want["candidates"]["scatter"]) == ["lane_rows_per_sec", "sec_per_pass"]
    assert got["winner"] in (None, "segment")
    assert tfs.sparse_candidates(512) == jfs.sparse_candidates(512)
    assert tfs.sparse_candidates(4096) == jfs.sparse_candidates(4096)


def test_every_candidate_is_timed_or_failed_with_a_reason():
    x, y, wt, off = _skewed_dense(2, 3, 512, 6)
    report = _race(x, y, wt, off)
    assert set(report["candidates"]) == set(tfs.sparse_candidates(512)) | {"dense"}
    assert "pallas:256" in report["candidates"]
    for name, rec in report["candidates"].items():
        assert ("sec_per_pass" in rec and rec["sec_per_pass"] > 0) or rec.get("failed"), name
    # each code path is timed once; the names that share one say which
    timed = {name for name, rec in report["candidates"].items() if "sec_per_pass" in rec}
    assert timed == {"segment", "pallas", "dense"}
    for name, same in (("scatter", "segment"), ("flat", "segment"), ("pallas:256", "pallas")):
        assert report["candidates"][name] == {
            "failed": f"skipped: the port runs it as {same}, timed once"}
    assert report["winner"] in ("segment", "pallas", None)


def test_injected_failures_are_recorded(monkeypatch):
    x, y, wt, off = _skewed_dense(3, 4, 16, 12)
    plain = tfs.fused_value_grad_parts

    def broken(*a, **kw):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(tfs, "fused_value_grad_parts", broken)
    report = _race(x, y, wt, off)
    for name in ("pallas",):
        assert report["candidates"][name] == {
            "failed": "error: RuntimeError: injected launch failure"}
    assert report["winner"] != "pallas"

    def off_by_an_ulp(*a, **kw):
        lv, grad, sum_d = plain(*a, **kw)
        return torch.nextafter(lv, lv + 1), grad, sum_d

    monkeypatch.setattr(tfs, "fused_value_grad_parts", off_by_an_ulp)
    rec = _race(x, y, wt, off)["candidates"]["pallas"]["failed"]
    assert rec.startswith("numerics: not bitwise-equal to the segment baseline") and "max |diff|" in rec


@pytest.mark.parametrize("e,m,d,density", [(5, 7, 12, 0.4), (64, 300, 9, 1.0),
                                            (3, 2048, 9, 1.0), (7, 33, 40, 0.2)])
def test_flat_order_plan_is_the_cpu_transpose_bitwise(e, m, d, density):
    """The card's plain transpose (``FlatOrderPlan``, one add per step down
    the longest column) adds each column's slots in the flat order that the
    CPU's ``index_add_`` adds them in: bitwise the same sums."""
    g = torch.Generator().manual_seed(e * m)
    x = torch.randn((e, m, d), generator=g) * (torch.rand((e, m, d), generator=g) < density)
    slab = tfs.build_sparse_slab(x, bucketer="off")
    plan = tfs.FlatOrderPlan.build(slab.idx, slab.val, d)
    assert len(plan.steps) == int((x != 0).sum(dim=-2).max())  # the longest column
    for contrib in (slab.val * torch.randn((e, m, 1), generator=g),
                    slab.val.square() * torch.randn((e, m, 1), generator=g)):
        want = slab._transpose_apply(contrib)
        assert torch.equal(plan.apply(contrib).reshape(want.shape), want)


def test_race_decisions_are_logged_and_adopted(monkeypatch, clean_cache):
    x, y, wt, off = _skewed_dense(8, 3, 8, 6)
    t = lambda a: torch.from_numpy(a)
    slab = tfs.build_sparse_slab(t(x))
    args = (t(x), t(y), t(off), t(wt))
    monkeypatch.setattr(tfg, "race_log", [])
    winner = tfs.select_sparse_kernel(TASK, slab, *args, spec="auto", label="b0")
    tfs.select_sparse_kernel(TASK, slab, *args, spec="auto", label="b1")  # from the cache
    e, m, k = slab.idx.shape
    key = (tlosses.logistic.name, e, m, k, 6, "float32", "cpu", None)
    assert tfg.race_log == [("sparse", key, winner)] * 2
    # a resumed run adopts the recorded decisions (as JSON gives them back)
    # and races nothing: here the recorded winner is another family
    monkeypatch.setattr(tfs, "_race_cache", {})
    monkeypatch.setattr(tfs, "race_sparse_kernels", lambda *a, **kw: pytest.fail("raced"))
    recorded = "pallas" if winner != "pallas" else "segment"
    tfs.adopt_race_decisions([["sparse", list(key), recorded],
                              ["dense", ["logistic", 131072, 33, "float32", "cuda:0", "auto"], 8]])
    assert tfs.select_sparse_kernel(TASK, slab, *args, spec="auto") == recorded
    assert tfg._autotune_cache[("logistic", 131072, 33, "float32", "cuda:0", "auto")] == 8
    del tfg._autotune_cache[("logistic", 131072, 33, "float32", "cuda:0", "auto")]


def test_race_cache_key_and_reports(monkeypatch, clean_cache):
    x, y, wt, off = _skewed_dense(4, 3, 8, 6)
    t = lambda a: torch.from_numpy(a)
    slab = tfs.build_sparse_slab(t(x))
    calls = []
    real = tfs.race_sparse_kernels

    def counted(*a, **kw):
        calls.append(a[1].val.dtype)
        return real(*a, **kw)

    monkeypatch.setattr(tfs, "race_sparse_kernels", counted)
    args = (t(x), t(y), t(off), t(wt))
    first = tfs.select_sparse_kernel(TASK, slab, *args, spec="auto", label="bucket0")
    assert tfs.select_sparse_kernel(TASK, slab, *args, spec="auto", label="bucket1") == first
    assert len(calls) == 1  # the second bucket of that key hit the cache
    (key, report), = tfs.race_reports().items()
    e, m, k = slab.idx.shape
    assert key == ("bucket0", tlosses.logistic.name, e, m, k, 6, "float32", "cpu", None)
    assert report["winner"] == first
    # another dtype, or a narrowed race, misses the cache
    tfs.select_sparse_kernel(TASK, slab.astype(torch.float64), *args, spec="auto")
    tfs.select_sparse_kernel(TASK, slab, *args, spec="auto", candidates=("flat",))
    assert len(calls) == 3
    assert tfs.select_sparse_kernel(TASK, slab, *args, spec="off") is None
    assert tfs.select_sparse_kernel(TASK, slab, *args, spec="flat") == "flat"


def test_f64_disqualifies_pallas_with_a_reason():
    x, y, wt, off = _skewed_dense(5, 3, 8, 8, np.float64)
    report = _race(x, y, wt, off)
    assert report["candidates"]["pallas"] == {
        "failed": "skipped: pallas family ineligible under float64"}
    assert "sec_per_pass" in report["candidates"]["segment"]


def test_auto_selects_per_dataset(monkeypatch, clean_cache):
    x, y, wt, off = _skewed_dense(6, 5, 16, 10)
    t = lambda a: torch.from_numpy(a)
    slab = tfs.build_and_select(TASK, t(x), t(y), t(off), t(wt), "auto", "re")
    assert slab is None or slab.kernel in tfs.sparse_candidates(16)
    # the coordinate races at construction and keeps the winner's slab
    monkeypatch.setattr(tfs, "_race_cache", {})
    rng = np.random.default_rng(7)
    n, d = 60, 5
    feats = tgame.HostFeatures(np.arange(n + 1, dtype=np.int64) * d,
                               np.tile(np.arange(d, dtype=np.int32), n),
                               rng.normal(size=n * d).astype(np.float32), d)
    data = tgame.GameData((rng.random(n) < 0.5).astype(np.float32), np.zeros(n, np.float32),
                          np.ones(n, np.float32), {"userId": rng.integers(0, 6, n).astype(np.int32)},
                          {"userId": [f"u{i}" for i in range(6)]}, {"per_user": feats})
    ds = tgame.build_random_effect_dataset(data, tgame.RandomEffectDataConfig("userId", "per_user"),
                                           device="cpu")
    coord = RandomEffectCoordinate(ds, TASK, solve_label="re-auto", sparse_kernel="auto")
    (key, report), = ((k, r) for k, r in tfs.race_reports().items() if k[0] == "re-auto")
    assert (coord.slab is None) == (report["winner"] is None)
    if coord.slab is not None:
        assert coord.slab.kernel == report["winner"]


def test_sparse_spec_auto_matches_jax(monkeypatch):
    monkeypatch.delenv("PHOTON_SPARSE_KERNEL", raising=False)
    for spec in ("auto", "on", "race", "AUTO"):
        assert tfs.resolve_sparse_kernel(spec) == jfs.resolve_sparse_kernel(spec) == "auto"
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "auto")
    assert tfs.resolve_sparse_kernel(None) == "auto"


@pytest.mark.parametrize("mode", ["auto", "0", "1", " AUTO "])
def test_dense_race_grammar_and_cpu_answer(monkeypatch, mode):
    monkeypatch.setenv("PHOTON_ML_TPU_FUSED", mode)
    assert tfg.fused_mode() == mode.strip().lower()
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        assert tfg.select_fused_block_rows(tlosses.logistic, 262144, 512, dtype, "cpu") is None
    assert tfg.autotune_report(tlosses.poisson, 1000, 33, torch.float32, "cpu") == {
        "winner": None, "candidates": {}}


def test_dense_race_refuses_a_bad_mode(monkeypatch):
    monkeypatch.setenv("PHOTON_ML_TPU_FUSED", "sometimes")
    with pytest.raises(ValueError, match="PHOTON_ML_TPU_FUSED"):
        tfg.select_fused_block_rows(tlosses.logistic, 100, 8, torch.float32, "cpu")
