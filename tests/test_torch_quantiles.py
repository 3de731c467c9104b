"""The port's streaming quantiles (photon_ml_tpu_torch/slo/quantiles.py)
against the JAX package's on the same samples, made from a numpy seed:
exact nearest-rank while buffered, the same P² marker arithmetic after the
digest passes ``exact_limit``."""

import numpy as np
import pytest

from photon_ml_tpu.slo import quantiles as jq
from photon_ml_tpu_torch.slo import quantiles as tq


def _samples(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":
        return rng.lognormal(mean=-6.0, sigma=0.8, size=n)
    if kind == "bimodal":
        return np.where(rng.random(n) < 0.9, rng.normal(1e-3, 1e-4, n), rng.normal(5e-2, 1e-2, n))
    return np.sort(rng.random(n))  # ascending: every sample a new maximum


@pytest.mark.parametrize("kind", ["lognormal", "bimodal", "sorted"])
@pytest.mark.parametrize("n,exact_limit", [(50, 100), (100, 100), (5000, 100), (20000, 1000)])
def test_digest_equals_the_jax_digest(kind, n, exact_limit):
    qs = (0.5, 0.9, 0.99)
    t = tq.StreamingQuantileDigest(qs, exact_limit=exact_limit)
    j = jq.StreamingQuantileDigest(qs, exact_limit=exact_limit)
    for i, x in enumerate(_samples(kind, n, n + exact_limit)):
        t.add(x)
        j.add(x)
        if i % 997 == 0:
            assert [t.quantile(q) for q in qs] == [j.quantile(q) for q in qs]
    assert t.count == j.count == n
    assert t.exact == j.exact == (n <= exact_limit)
    assert [t.quantile(q) for q in qs] == [j.quantile(q) for q in qs]
    if n > exact_limit:
        with pytest.raises(KeyError):
            t.quantile(0.75)
    t.reset()
    assert t.count == 0 and t.quantile(0.5) == 0.0


def test_exact_percentile_and_seeded_markers_equal_the_jax_ones():
    vals = sorted(_samples("lognormal", 777, 3))
    for q in (0.0, 0.01, 0.5, 0.99, 1.0):
        assert tq.exact_percentile(vals, q) == jq.exact_percentile(vals, q)
    assert tq.exact_percentile([], 0.5) == 0.0
    for q in (0.01, 0.5, 0.99):
        t, j = tq.P2Quantile.from_sorted(q, vals), jq.P2Quantile.from_sorted(q, vals)
        assert (t._h, t._n) == (j._h, j._n)
        for x in _samples("bimodal", 300, 9):
            t.add(x)
            j.add(x)
        assert t.value() == j.value() and t.count == j.count
    with pytest.raises(ValueError, match="needs >= 5"):
        tq.P2Quantile.from_sorted(0.5, [1.0, 2.0])
    with pytest.raises(ValueError, match="quantile"):
        tq.P2Quantile(1.5, [0.0] * 5, [1.0, 2.0, 3.0, 4.0, 5.0])
    with pytest.raises(ValueError, match="exact_limit"):
        tq.StreamingQuantileDigest(exact_limit=4)
