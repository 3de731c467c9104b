"""``--persistent-cache DIR``: the port's counterpart of XLA's persistent
compilation cache is the build directory of its own compiled code
(``native_build``: the CUDA kernels with nvcc, the host libraries of
``native/`` with g++). A start builds into DIR what DIR lacks, a warm start
builds nothing, and ``--assert-warm`` (serve driver and fleet replica) fails a
start that built anything or warmed a batch shape DIR had not recorded, so
the gate never holds vacuously (photon_ml_tpu/cli/serve_driver.py:100-140).
Runs on the CPU: the host libraries are built with g++ here."""

import io
import os
import socket
import threading
import time

import pytest

from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.cli import serve_driver
from photon_ml_tpu_torch.cli.game_params import GameServeParams
from photon_ml_tpu_torch.compile.stats import CompileStats, compile_stats
from test_game_drivers import game_avro_dirs  # noqa: F401
from test_torch_game_driver import _argv
from test_torch_serve import serving_world  # noqa: F401


def _serve(store_dir, cache, **kw):
    d = serve_driver.GameServeDriver(GameServeParams(
        model_store_dir=store_dir, persistent_cache_dir=cache, device="cpu", **kw))
    try:
        d.run(in_stream=io.StringIO(""), out_stream=io.StringIO())
    finally:
        # the flag's scope is the driver's run: the process builds where it did
        assert native_build.BUILD_DIR == native_build.DEFAULT_BUILD_DIR
    return d


def test_a_build_lands_in_the_cache_dir_and_is_counted(tmp_path):
    cache = str(tmp_path / "cache")
    with native_build.use_persistent_cache(cache) as mark:
        assert native_build.BUILD_DIR == os.path.abspath(cache)
        path = native_build.build_host("libsvm_parser.cpp")
        assert os.path.dirname(path) == os.path.abspath(cache) and os.path.exists(path)
        assert mark.new_builds() == 1 and os.listdir(cache) == [os.path.basename(path)]
        again = compile_stats.watermark()
        assert native_build.build_host("libsvm_parser.cpp") == path
        assert again.new_builds() == 0  # a warm library is loaded, not rebuilt
        with native_build.use_persistent_cache(None) as none:  # no flag: nothing moves
            assert none is None and native_build.BUILD_DIR == os.path.abspath(cache)
    assert native_build.BUILD_DIR == native_build.DEFAULT_BUILD_DIR


def test_switching_the_dir_drops_libraries_loaded_from_another(tmp_path):
    from photon_ml_tpu_torch.io import offheap

    with native_build.use_persistent_cache(str(tmp_path / "a")):
        offheap._load_native()
        assert "native/pmix_store.cpp" in native_build._loaded
        lib_a = native_build._loaded["native/pmix_store.cpp"]
        with native_build.use_persistent_cache(str(tmp_path / "b")) as mark:
            assert native_build._loaded == {}
            offheap._load_native()  # loaded again, built into the new dir
            assert mark.new_builds() == 1 and len(os.listdir(tmp_path / "b")) == 1
        # leaving a scope brings back the dir and the libraries loaded there
        assert native_build.BUILD_DIR == os.path.abspath(tmp_path / "a")
        assert native_build._loaded["native/pmix_store.cpp"] is lib_a
    assert native_build.BUILD_DIR == native_build.DEFAULT_BUILD_DIR


def test_the_stats_count_builds_apart_from_captures():
    s = CompileStats()
    mark = s.watermark()
    s.record_build()
    s.record_build()
    assert mark.new_builds() == 2 and mark.new_traces() == 0 and mark.clean()
    s.reset()
    assert s.native_builds == 0


def test_a_warm_serve_start_builds_nothing_and_asserts_warm(serving_world, tmp_path):  # noqa: F811
    cache = str(tmp_path / "cache")
    store = serving_world["store_dir"]
    cold = _serve(store, cache)
    assert cold.cache_report["new_shapes"] == cold.cache_report["warm_shapes"] > 0
    assert not cold.server.fully_warm()
    assert os.path.exists(os.path.join(cache, "serve-shapes.json"))
    warm = _serve(store, cache, assert_warm=True)
    assert warm.cache_report == {"builds": 0, "new_shapes": 0,
                                 "warm_shapes": cold.cache_report["warm_shapes"]}
    assert warm.server.fully_warm()


def test_a_changed_ladder_fails_assert_warm(serving_world, tmp_path):  # noqa: F811
    cache = str(tmp_path / "cache")
    store = serving_world["store_dir"]
    _serve(store, cache, max_batch_rows=16)
    with pytest.raises(RuntimeError, match="warmed [1-9][0-9]* batch shapes the persistent "
                                           "cache had not seen"):
        _serve(store, cache, max_batch_rows=64, assert_warm=True)
    _serve(store, cache, max_batch_rows=64, assert_warm=True)  # now recorded


def test_a_cold_library_fails_assert_warm(serving_world, tmp_path, monkeypatch):  # noqa: F811
    """A start that had to build a library is not warm even when every
    shape is known: the build itself is the compile the gate forbids."""
    cache = str(tmp_path / "cache")
    store = serving_world["store_dir"]
    _serve(store, cache)
    mark = compile_stats.watermark()
    monkeypatch.setattr(compile_stats, "watermark", lambda: mark)
    compile_stats.record_build()
    with pytest.raises(RuntimeError, match="startup built 1 native libraries"):
        _serve(store, cache, assert_warm=True)


def test_a_fleet_replica_asserts_warm_against_its_cache(serving_world, tmp_path):  # noqa: F811
    from photon_ml_tpu_torch.cli import fleet_driver
    from photon_ml_tpu_torch.cli.game_params import GameFleetParams
    from photon_ml_tpu_torch.compile import ShapeBucketer
    from photon_ml_tpu_torch.serve.fleet import build_fleet_stores

    fleet = str(tmp_path / "fleet")
    build_fleet_stores(serving_world["model_dir"], fleet, num_replicas=2,
                       bucketer=ShapeBucketer())
    cache = str(tmp_path / "cache")

    def replica(assert_warm):
        d = fleet_driver.GameFleetDriver(GameFleetParams(
            fleet_dir=fleet, replica_id=0, num_fleet_replicas=2, persistent_cache_dir=cache,
            assert_warm=assert_warm, device="cpu", warm_nnz=8, max_batch_rows=16))
        return d

    cold = replica(True)
    with pytest.raises(RuntimeError, match="--assert-warm: replica startup built"):
        cold.run_replica(out_stream=io.StringIO())
    warm = replica(True)
    out = io.StringIO()
    th = threading.Thread(target=warm.run_replica, kwargs={"out_stream": out}, daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while "READY" not in out.getvalue() and time.monotonic() < deadline and th.is_alive():
        time.sleep(0.05)
    assert "READY" in out.getvalue()
    assert warm.cache_report["builds"] == 0 and warm.cache_report["new_shapes"] == 0
    host, _, port = out.getvalue().split()[1].rpartition(":")
    with socket.create_connection((host, int(port)), timeout=10) as s:
        s.sendall(b'{"cmd": "shutdown"}\n')
        s.recv(100)
    th.join(timeout=30)
    assert not th.is_alive() and native_build.BUILD_DIR == native_build.DEFAULT_BUILD_DIR


def test_the_game_driver_builds_its_host_libraries_into_the_cache(game_avro_dirs,  # noqa: F811
                                                                   tmp_path):
    """A GAME run with ``--persistent-cache`` builds the native Avro decoder
    into DIR; the next run over the same cache builds nothing and logs the
    warm start, and its model is the first's, byte for byte."""
    from photon_ml_tpu_torch.cli import game_training_driver as tdriver

    train_dir, val_dir, _ = game_avro_dirs
    cache = str(tmp_path / "cache")
    argv = lambda out: _argv(train_dir, val_dir, str(tmp_path / out), "LBFGS") + [
        "--device", "cpu", "--persistent-cache", cache]
    mark = compile_stats.watermark()
    tdriver.main(argv("cold"))
    assert mark.new_builds() >= 1
    assert native_build.BUILD_DIR == native_build.DEFAULT_BUILD_DIR  # the run's scope ended
    assert any(name.startswith("libavro_decoder-host-") for name in os.listdir(cache))
    warm_mark = compile_stats.watermark()
    tdriver.main(argv("warm"))
    assert warm_mark.new_builds() == 0
    with open(tmp_path / "warm" / "photon-ml-tpu-game.log") as f:
        assert "persistent cache fully warm: nothing built" in f.read()
    assert _tree_bytes(str(tmp_path / "warm" / "best")) == \
        _tree_bytes(str(tmp_path / "cold" / "best"))


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, name), root)] = f.read()
    return out
