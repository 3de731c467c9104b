"""Build the package's native sources and load them with ctypes.

Two kinds of source, one build directory:

  * the CUDA kernels under ``csrc/``, compiled on first use with nvcc
    (``build`` / ``load``);
  * the host runtime pieces under the repository's ``native/`` (the Avro
    decoder, the LIBSVM parser, the off-heap index store), plain C++
    shared with the JAX package and compiled on first use with g++
    (``build_host`` / ``load_host``).

Each becomes ``_build/lib<stem>-<hash>.so`` inside the package (the hash
covers the source, the shared headers and the flags, so an edited source
never loads a stale library). Nothing is prebuilt: a library is made from
the sources in the checkout on the machine that runs it. A failed build
raises with the compiler's output. Every build is counted in
``compile.stats.compile_stats.native_builds``.

``use_persistent_cache(DIR)`` is the drivers' ``--persistent-cache DIR``: the port's
counterpart of XLA's persistent compilation cache is this directory of
built libraries, so a start whose libraries are already in DIR launches no
``nvcc`` or ``g++`` process. ``PHOTON_ML_TPU_NATIVE=0`` is the one way
to ask for the pure-Python host paths instead (``native_enabled``); the
host libraries are never skipped quietly.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, Sequence

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
# where libraries are built and loaded from (use_persistent_cache moves it)
BUILD_DIR = DEFAULT_BUILD_DIR
# the framework-free C++ sources shared with the JAX package
NATIVE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "native")
NATIVE_ENV = "PHOTON_ML_TPU_NATIVE"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler report (registers, shared memory, spills) of each build, by the
# library's path
build_logs: Dict[str, str] = {}


def native_enabled() -> bool:
    """False when ``PHOTON_ML_TPU_NATIVE`` asks for the pure-Python host
    paths (0, false, no)."""
    return os.environ.get(NATIVE_ENV, "1").strip().lower() not in ("0", "false", "no")


@contextlib.contextmanager
def use_persistent_cache(directory, logger=None):
    """A driver's ``--persistent-cache DIR`` for the length of the block:
    build and load every library in ``directory`` (logged) and yield a
    ``compile_stats`` watermark, whose ``new_builds()`` is 0 after a warm
    start. Libraries loaded from another directory are dropped from the
    process's cache meanwhile, so each kernel or host reader loads, or
    builds, its library in ``directory``. On exit the process builds and
    loads where it did before, with the libraries it had loaded there.
    Without a directory nothing moves and the block gets None."""
    if not directory:
        yield None
        return
    from photon_ml_tpu_torch.compile.stats import compile_stats

    global BUILD_DIR
    path = os.path.abspath(directory)
    os.makedirs(path, exist_ok=True)
    with _lock:
        before, loaded = BUILD_DIR, dict(_loaded)
        if path != BUILD_DIR:
            BUILD_DIR = path
            _loaded.clear()
    if logger is not None:
        logger.info(f"persistent kernel build cache: {path}")
    try:
        yield compile_stats.watermark()
    finally:
        with _lock:
            BUILD_DIR = before
            _loaded.clear()
            _loaded.update(loaded)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "photon_ml_tpu_torch are built from source on the machine with the card"
    )


def library_path(source_name: str, flags: Sequence[str] = NVCC_FLAGS,
                 csrc_dir: str = CSRC_DIR) -> str:
    """The library's path; its hash covers the source, every shared header
    of its directory (``*.cuh``) and the flags."""
    h = hashlib.sha256(repr(tuple(flags)).encode())
    headers = sorted(n for n in os.listdir(csrc_dir) if n.endswith(".cuh"))
    for name in [source_name] + headers:
        with open(os.path.join(csrc_dir, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    digest = h.hexdigest()
    stem = os.path.splitext(source_name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def _compile(command: Sequence[str], out: str, what: str) -> str:
    """Run ``command`` (its output file given as ``{out}``) into a temporary
    file beside ``out``, then rename it into place: processes building
    one library at once (test workers) never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([tmp if a == "{out}" else a for a in command],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{what} (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        build_logs[out] = proc.stdout + proc.stderr
        os.replace(tmp, out)
        from photon_ml_tpu_torch.compile.stats import compile_stats

        compile_stats.record_build()
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(source_name: str, flags: Sequence[str] = NVCC_FLAGS,
          csrc_dir: str = CSRC_DIR) -> str:
    """Compile ``<csrc_dir>/<source_name>`` (by default the package's
    ``csrc/``) unless its library exists; return the library's path. Raises
    with the compiler's output if nvcc fails."""
    out = library_path(source_name, flags, csrc_dir)
    if os.path.exists(out):
        return out
    return _compile([nvcc_path(), *flags, "-o", "{out}", os.path.join(csrc_dir, source_name)],
                    out, f"nvcc failed on {source_name}")


def gxx_path() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError(
            "g++ not found (PATH, $CXX): the host libraries of photon_ml_tpu_torch "
            "(native/*.cpp) are built from source; set PHOTON_ML_TPU_NATIVE=0 to "
            "use the pure-Python paths instead"
        )
    return found


def host_library_path(source_name: str, libs: Sequence[str] = ()) -> str:
    """The host library's path; its hash covers the source and the flags."""
    h = hashlib.sha256(repr((HOST_FLAGS, tuple(libs))).encode())
    with open(os.path.join(NATIVE_DIR, source_name), "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(source_name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-host-{h.hexdigest()[:16]}.so")


def build_host(source_name: str, libs: Sequence[str] = ()) -> str:
    """Compile ``native/<source_name>`` with g++ unless its library exists;
    return the library's path. ``libs`` (``-lz``) follow the source, or GNU
    ld drops them. Raises with the compiler's output if g++ fails."""
    out = host_library_path(source_name, libs)
    if os.path.exists(out):
        return out
    return _compile([gxx_path(), *HOST_FLAGS, "-o", "{out}",
                     os.path.join(NATIVE_DIR, source_name), *libs],
                    out, f"g++ failed on native/{source_name}")


def load(source_name: str, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed) and load one source's library; ``configure`` sets
    every function's ``argtypes`` and ``restype``."""
    with _lock:
        lib = _loaded.get(source_name)
        if lib is None:
            lib = ctypes.CDLL(build(source_name))
            configure(lib)
            _loaded[source_name] = lib
        return lib


def load_host(source_name: str, configure: Callable[[ctypes.CDLL], None],
              libs: Sequence[str] = ()) -> ctypes.CDLL:
    """``load`` for a host source of ``native/`` (built by ``build_host``)."""
    key = "native/" + source_name
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(build_host(source_name, libs))
            configure(lib)
            _loaded[key] = lib
        return lib
