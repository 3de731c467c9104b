"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled on first use into a shared library
with a plain C interface, ``_build/lib<stem>-<hash>.so`` inside the package
(the hash covers the source and the flags, so an edited source never loads a
stale library). Nothing is prebuilt: the library is made from the sources in
the checkout on the machine that has the card.
"""

from __future__ import annotations

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
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler report (registers, shared memory, spills) of each build, by stem
build_logs: Dict[str, str] = {}


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


def library_path(source_name: str, flags: Sequence[str] = NVCC_FLAGS) -> str:
    with open(os.path.join(CSRC_DIR, source_name), "rb") as f:
        digest = hashlib.sha256(f.read() + repr(tuple(flags)).encode()).hexdigest()
    stem = os.path.splitext(source_name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def build(source_name: str, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Compile ``csrc/<source_name>`` unless its library exists; return the
    library's path. Raises with the compiler's output if nvcc fails."""
    out = library_path(source_name, flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *flags, "-o", tmp, os.path.join(CSRC_DIR, source_name)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source_name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        build_logs[os.path.splitext(source_name)[0]] = proc.stdout + proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


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
