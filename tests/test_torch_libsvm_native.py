"""The port's native LIBSVM parse against its Python parser and the JAX
package's ``read_libsvm`` (CPU), byte-equal, with the malformed-token and
overflow guards of tests/test_avro_native.py, and ``parse_counts``
recording which parser read each file.
"""

import numpy as np
import pytest

from photon_ml_tpu.io import libsvm as jlibsvm
from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.io import libsvm as tlibsvm


def _write(path, rng, n=400, d=60, labels=(-1, 1)):
    lines = []
    for i in range(n):
        cols = np.sort(rng.choice(d, size=int(rng.integers(0, 9)), replace=False))
        toks = " ".join(f"{c + 1}:{rng.normal():.6g}" for c in cols)
        tail = " # comment" if i % 7 == 0 else ""
        lines.append(f"{rng.choice(labels)} {toks}{tail}")
        if i % 50 == 0:
            lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _same(a, b):
    for f in ("labels", "indptr", "indices", "values"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert a.dim == b.dim


@pytest.mark.parametrize("labels", [(-1, 1), (0, 1), (0.5, 2.0)])
@pytest.mark.parametrize("add_intercept,dim", [(True, None), (False, None), (True, 80)])
def test_native_python_and_jax_parse_the_same_arrays(tmp_path, monkeypatch, labels,
                                                     add_intercept, dim):
    path = _write(tmp_path / "a.txt", np.random.default_rng(len(labels) + (dim or 0)),
                  labels=labels)
    before = dict(tlibsvm.parse_counts)
    native = tlibsvm.read_libsvm(path, dim=dim, add_intercept=add_intercept)
    assert tlibsvm.parse_counts["native_files"] == before["native_files"] + 1
    with monkeypatch.context() as m:
        m.setenv(native_build.NATIVE_ENV, "0")
        python = tlibsvm.read_libsvm(path, dim=dim, add_intercept=add_intercept)
    assert tlibsvm.parse_counts["python_files"] == before["python_files"] + 1
    _same(native, python)
    _same(native, jlibsvm.read_libsvm(path, dim=dim, add_intercept=add_intercept))


def test_zero_based_indices(tmp_path):
    path = tmp_path / "z.txt"
    path.write_text("1 0:1.5 3:2\n0 2:-1\n")
    got = tlibsvm.read_libsvm(str(path), zero_based=True, add_intercept=False)
    _same(got, jlibsvm.read_libsvm(str(path), zero_based=True, add_intercept=False))
    assert got.indices.tolist() == [0, 3, 2]


@pytest.mark.parametrize("text,error", [
    ("1 2: 3.5\n", ValueError),  # a space after ':'
    ("1 5:\n0 1:1.0\n", ValueError),  # a value must not cross lines
    ("1 3000000000:1.0\n", OverflowError),
])
def test_malformed_files_raise_the_python_parsers_error(tmp_path, text, error):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    before = dict(tlibsvm.parse_counts)
    with pytest.raises(error):
        tlibsvm.read_libsvm(str(path))
    assert tlibsvm.parse_counts["python_files"] == before["python_files"] + 1
    with pytest.raises(error):
        jlibsvm.read_libsvm(str(path))
