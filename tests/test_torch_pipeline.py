"""The port's pipelined data path (photon_ml_tpu_torch/io/pipeline.py), the
cases of tests/test_pipeline.py (CPU):

  * ``Prefetcher``: order, a background thread, bounded read-ahead, an
    exception delivered at its position, an injected ``io.cache_read``
    fault crossing the thread, depth 0 synchronous, single pass, and
    ``PHOTON_PREFETCH_DEPTH``;
  * ``device_pipelined``: order, look-ahead, depth 0 lazy, and the stage
    keeping no reference to a block it handed out;
  * ``pipelined_to_device`` with a CPU ``place``: the same blocks at every
    depth, as writable tensors on the device asked for.

The card's pinned side-stream placement is held bitwise against the
synchronous copy by the ``gpu``-marked tests of
``tests/test_torch_kernel_gpu.py``.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from photon_ml_tpu.io import pipeline as jpipeline
from photon_ml_tpu_torch.io import pipeline as tpipeline
from photon_ml_tpu_torch.io.pipeline import (
    PinnedH2D,
    Prefetcher,
    device_pipelined,
    pipelined_to_device,
    prefetched,
    resolve_depth,
)
from photon_ml_tpu_torch.resilience import faults


class TestPrefetcher:
    def test_close_joins_the_worker(self):
        """A consumer that stops early leaves no worker behind: close()
        waits for the item in hand (a process that exits with a worker
        inside a pinned copy can abort at teardown)."""
        started = threading.Event()

        def gen():
            for i in range(1000):
                started.set()
                time.sleep(0.01)
                yield i

        p = Prefetcher(gen, depth=2, name="close-test")
        it = iter(p)
        assert next(it) == 0 and started.wait(5.0)
        it.close()  # the generator's finally closes the prefetcher
        assert p._thread is not None and not p._thread.is_alive()

    def test_preserves_order(self):
        assert list(prefetched(lambda: iter(range(100)), depth=3)) == list(range(100))

    def test_depth_zero_is_synchronous_passthrough(self):
        produced = []

        def gen():
            for i in range(5):
                produced.append(i)
                yield i

        it = prefetched(gen, depth=0)
        assert produced == []
        assert next(it) == 0
        assert produced == [0]

    def test_runs_producer_on_background_thread(self):
        main = threading.get_ident()
        seen = []

        def gen():
            seen.append(threading.get_ident())
            yield 1

        assert list(prefetched(gen, depth=2)) == [1]
        assert seen and seen[0] != main

    def test_bounded_readahead(self):
        produced = []
        depth = 2

        def gen():
            for i in range(50):
                produced.append(i)
                yield i

        p = Prefetcher(gen, depth=depth)
        it = iter(p)
        next(it)
        deadline = time.monotonic() + 5.0
        while len(produced) < 1 + depth and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        assert len(produced) <= 1 + depth + 1
        p.close()

    def test_exception_propagates_in_order(self):
        def gen():
            yield "a"
            yield "b"
            raise ValueError("boom at item 2")

        it = prefetched(gen, depth=4)
        assert next(it) == "a"
        assert next(it) == "b"
        with pytest.raises(ValueError, match="boom at item 2"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)

    def test_injected_cache_read_fault_propagates(self):
        plan = faults.FaultPlan([faults.FaultSpec(site="io.cache_read", at=3, kind="io")])

        def loads():
            for i in range(6):
                faults.inject("io.cache_read", block=i)
                yield i

        got = []
        with faults.fault_scope(plan):
            with pytest.raises(faults.InjectedIOError):
                for item in prefetched(loads, depth=2):
                    got.append(item)
        assert got == [0, 1]
        assert plan.fire_count("io.cache_read") == 1

    def test_single_pass(self):
        p = Prefetcher(lambda: iter(range(3)), depth=2)
        assert list(p) == [0, 1, 2]
        with pytest.raises(RuntimeError, match="single-pass"):
            iter(p)

    @pytest.mark.parametrize("raw,want", [(None, 2), ("0", 0), ("5", 5)])
    def test_depth_env(self, monkeypatch, raw, want):
        if raw is None:
            monkeypatch.delenv("PHOTON_PREFETCH_DEPTH", raising=False)
        else:
            monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", raw)
        assert resolve_depth(None) == jpipeline.resolve_depth(None) == want
        assert resolve_depth(7) == 7
        monkeypatch.setenv("PHOTON_PREFETCH_DEPTH", "x")
        with pytest.raises(ValueError, match="must be an integer"):
            resolve_depth(None)
        assert tpipeline.DEFAULT_DEPTH == jpipeline.DEFAULT_DEPTH


class TestDevicePipelined:
    def test_order_and_values(self):
        assert list(device_pipelined(range(10), lambda v: v * 2, depth=1)) == \
            [v * 2 for v in range(10)]

    def test_places_ahead(self):
        placed, out = [], []
        for v in device_pipelined(range(5), lambda v: placed.append(v) or v, depth=1):
            assert len(placed) >= min(v + 2, 5)
            out.append(v)
        assert out == list(range(5))

    def test_depth_zero_lazy(self):
        placed = []
        it = device_pipelined(range(5), lambda v: placed.append(v) or v, depth=0)
        assert placed == []
        assert next(it) == 0
        assert placed == [0]

    def test_ready_runs_on_every_block_in_order(self):
        seen = []
        out = list(device_pipelined(range(4), lambda v: v, depth=1,
                                    ready=lambda v: seen.append(v) or -v))
        assert out == [0, -1, -2, -3] and seen == [0, 1, 2, 3]

    def test_the_stage_drops_a_handed_out_block(self):
        class Block:
            pass

        refs = []

        def place(i):
            b = Block()
            refs.append(weakref.ref(b))
            return b

        it = device_pipelined(range(6), place, depth=1)
        first = next(it)
        del first
        next(it)  # the stage holds the in-flight placements, not block 0
        gc.collect()
        assert refs[0]() is None


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_pipelined_to_device_gives_the_same_blocks_at_every_depth(depth):
    rng = np.random.default_rng(5)
    blocks = [{"x": rng.normal(size=(4, 3)).astype(np.float32), "i": np.arange(4) + k, "_k": k}
              for k in range(5)]
    host_threads = []

    def to_host(b):
        host_threads.append(threading.get_ident())
        return {k: (np.array(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}

    out = list(pipelined_to_device(lambda: iter(blocks), to_host, "cpu", depth))
    assert [o["_k"] for o in out] == list(range(5))
    for o, b in zip(out, blocks):
        assert isinstance(o["x"], torch.Tensor) and o["x"].device.type == "cpu"
        assert np.array_equal(o["x"].numpy(), b["x"]) and np.array_equal(o["i"].numpy(), b["i"])
        before = float(b["x"][0, 0])
        o["x"][0, 0] = before + 1.0  # writable, and not the source's memory
        assert b["x"][0, 0] == before
    main = threading.get_ident()
    assert (set(host_threads) == {main}) == (depth <= 0)


def test_pinned_stage_needs_a_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        PinnedH2D("cpu")
