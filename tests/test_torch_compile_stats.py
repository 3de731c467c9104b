"""The port's capture telemetry (photon_ml_tpu_torch/compile/stats.py)
against the JAX package's compile telemetry (CPU):

  * ``CompileStats`` keeps the JAX counters under the JAX names through the
    same events (a capture is the port's trace, a replay its call);
  * ``instrumented_capture`` captures once per key and replays after that;
  * the watermark counts the captures made since it was taken;
  * XLA's persistent-cache events have no counterpart: the listeners are
    not installed and the summary says so.
"""

import pytest

from photon_ml_tpu.compile import stats as jstats
from photon_ml_tpu_torch.compile import stats as tstats
from photon_ml_tpu_torch.compile.stats import CompileStats, instrumented_capture


def _events(s):
    s.record_trace("scheduler.rung")
    s.record_call("scheduler.rung", 0.25, traced=True)
    for _ in range(3):
        s.record_call("scheduler.rung", 0.001, traced=False)
    s.record_trace("other")
    s.record_call("other", 0.5, traced=True)
    s.site("idle")
    return s


def test_counters_are_the_jax_counters():
    got, want = _events(CompileStats()), _events(jstats.CompileStats())
    assert got.snapshot() == want.snapshot()
    assert got.total_traces() == want.total_traces() == 2
    assert got.traces_of("scheduler.rung") == want.traces_of("scheduler.rung") == 1
    assert got.snapshot()["scheduler.rung"]["cache_hits"] == 3
    got.reset()
    want.reset()
    assert got.snapshot() == want.snapshot() == {}


def test_watermark_counts_new_captures():
    s = _events(CompileStats())
    mark = s.watermark()
    assert mark.clean() and mark.new_traces() == 0 and mark.new_xla_misses() == 0
    s.record_call("scheduler.rung", 0.0, traced=False)
    assert mark.clean()
    s.record_trace("scheduler.rung")
    assert not mark.clean() and mark.new_traces() == 1


def test_instrumented_capture_captures_once_per_key(monkeypatch):
    s = CompileStats()
    monkeypatch.setattr(tstats, "compile_stats", s)
    cache, captured, replayed = {}, [], []

    def capture(key):
        return lambda: captured.append(key) or f"graph-{key}"

    for key in ("a", "a", "b", "a"):
        out = instrumented_capture("site", key, cache, capture(key),
                                   lambda graph: replayed.append(graph) or len(replayed))
    assert out == 4
    assert captured == ["a", "b"] and sorted(cache) == ["a", "b"]
    assert replayed == ["graph-a", "graph-a", "graph-b", "graph-a"]
    snap = s.snapshot()["site"]
    assert (snap["traces"], snap["calls"], snap["cache_hits"]) == (2, 4, 2)


@pytest.mark.parametrize("events", [False, True])
def test_summary_names_captures_and_the_missing_xla_cache(events):
    s = _events(CompileStats()) if events else CompileStats()
    assert s.install_xla_listeners() is False
    lines = s.summary().splitlines()
    assert lines[0].startswith(f"compile stats: {3 if events else 0} capture sites, "
                               f"{2 if events else 0} CUDA-graph captures")
    # the XLA cache's counterpart is the native build cache: its builds
    assert "native builds: 0 (nvcc/g++ into the build cache)" in lines[0]
    mark = s.watermark()
    s.record_build()
    assert mark.new_builds() == 1
    assert "native builds: 1 " in s.summary().splitlines()[0]
    if events:
        assert "  scheduler.rung: 1 captures / 4 calls (0.25s in capturing calls)" in lines
