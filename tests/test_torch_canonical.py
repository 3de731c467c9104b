"""The port's shape ladder (``photon_ml_tpu_torch.compile``) against the JAX
package's (CPU): the rungs, the spec grammar with its environment variable
and errors, and random-effect datasets padded up the ladder byte-equal to
the JAX package's."""

import numpy as np
import pytest
import torch

from game_test_utils import make_glmix_data
from photon_ml_tpu.compile import canonical as jcanon
from photon_ml_tpu.data.game import RandomEffectDataConfig as JReConfig
from photon_ml_tpu.data.game import build_random_effect_dataset as j_build
from photon_ml_tpu.ops import fused_sparse as jfs
from photon_ml_tpu_torch.compile import canonical as tcanon
from photon_ml_tpu_torch.data import game as tgame
from photon_ml_tpu_torch.ops import fused_sparse as tfs
from test_torch_game import _port_data

LADDERS = [(8, 2.0), (4, 1.5), (1, 1.1), (16, 3.0)]
SPECS = ["off", "false", "0", "none", "", "on", "true", "1", "default", "8:2", "16:1.5",
         " ON ", "3:1.25"]
BAD_SPECS = ["sideways", "8:x", "0:2", "8:1", "8:0.5", "a:b"]
FIELDS = tgame.RandomEffectDataset.TENSOR_FIELDS


@pytest.mark.parametrize("base,growth", LADDERS)
def test_rungs_and_description_match_jax(base, growth):
    t, j = tcanon.ShapeBucketer(base, growth), jcanon.ShapeBucketer(base, growth)
    sizes = list(range(-2, 300)) + [1000, 4097, 65537, 1 << 20]
    assert [t.canon(n) for n in sizes] == [j.canon(n) for n in sizes]
    assert t.describe() == j.describe()
    assert t.spec() == f"{base}:{growth:g}"


def test_spec_grammar_matches_jax(monkeypatch):
    for spec in SPECS + [True, False]:
        got, want = tcanon.resolve_bucketer(spec), jcanon.resolve_bucketer(spec)
        assert (got is None) == (want is None), spec
        if got is not None:
            assert (got.base, got.growth) == (want.base, want.growth), spec
    for bad in BAD_SPECS:
        with pytest.raises(ValueError, match="ladder"):
            tcanon.resolve_bucketer(bad)
        with pytest.raises(ValueError):
            jcanon.resolve_bucketer(bad)
    ladder = tcanon.ShapeBucketer(4, 3.0)
    assert tcanon.resolve_bucketer(ladder) is ladder
    # None reads PHOTON_SHAPE_LADDER, like the JAX package
    for env in ("4:2", "on", "off"):
        monkeypatch.setenv("PHOTON_SHAPE_LADDER", env)
        got, want = tcanon.resolve_bucketer(None), jcanon.resolve_bucketer(None)
        assert (got is None) == (want is None)
        assert got is None or got.spec() == f"{want.base}:{want.growth:g}"
    monkeypatch.setenv("PHOTON_SHAPE_LADDER", "sideways")
    with pytest.raises(ValueError, match="shape-ladder"):
        tcanon.resolve_bucketer(None)
    monkeypatch.delenv("PHOTON_SHAPE_LADDER")
    assert tcanon.resolve_bucketer(None) is None


@pytest.fixture(scope="module")
def glmix():
    rng = np.random.default_rng(11)
    data, _ = make_glmix_data(rng, num_users=11, rows_per_user_range=(3, 21), d_fixed=5,
                              d_random=5)
    return data, _port_data(data)


CONFIGS = {
    "plain": dict(random_effect_id="userId", feature_shard_id="per_user"),
    "capped": dict(random_effect_id="userId", feature_shard_id="per_user",
                   active_upper_bound=7, passive_lower_bound=1),
    "identity": dict(random_effect_id="userId", feature_shard_id="global",
                     projector="IDENTITY", num_shards=3),
}


@pytest.mark.parametrize("ladder", [(8, 2.0), (4, 1.5)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_canonicalized_dataset_is_byte_equal(glmix, name, ladder):
    jdata, tdata = glmix
    jds = jcanon.canonicalize_re_dataset(j_build(jdata, JReConfig(**CONFIGS[name])),
                                         jcanon.ShapeBucketer(*ladder))
    plain = tgame.build_random_effect_dataset(tdata, tgame.RandomEffectDataConfig(**CONFIGS[name]),
                                              device="cpu")
    tds = tcanon.canonicalize_re_dataset(plain, tcanon.ShapeBucketer(*ladder))
    assert (tds.num_entities, tds.global_dim) == (jds.num_entities, jds.global_dim)
    assert tds.x.shape[0] > plain.x.shape[0] or tds.x.shape[1] > plain.x.shape[1]
    for f in FIELDS:
        want, got = np.asarray(getattr(jds, f)), getattr(tds, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f
    # a None ladder only moves the tensors
    same = tcanon.canonicalize_re_dataset(plain, None, device="cpu")
    assert all(getattr(same, f).numpy().tobytes() == getattr(plain, f).numpy().tobytes()
               for f in FIELDS)


def test_random_projection_is_refused(glmix):
    _, tdata = glmix
    ds = tgame.build_random_effect_dataset(
        tdata, tgame.RandomEffectDataConfig("userId", "per_user", projector="RANDOM",
                                            random_projection_dim=3), device="cpu")
    with pytest.raises(ValueError, match="RANDOM"):
        tcanon.canonicalize_re_dataset(ds, tcanon.ShapeBucketer())


def test_pad_axis_matches_jax():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for axis, size, fill in ((0, 5, -1), (1, 8, 0.5), (1, 2, 0.0), (0, 3, 9)):
        got, want = tcanon.pad_axis(a, axis, size, fill), jcanon.pad_axis(a, axis, size, fill)
        assert got.tobytes() == want.tobytes() and got.shape == want.shape


@pytest.mark.parametrize("ladder", ["off", "on", "4:1.5", None])
def test_slab_width_rounds_up_the_ladder_as_in_jax(monkeypatch, ladder):
    """``build_sparse_slab``'s K up the ladder (capped at D), byte-equal to
    the JAX build; None reads PHOTON_SHAPE_LADDER."""
    monkeypatch.setenv("PHOTON_SHAPE_LADDER", "16:2")
    rng = np.random.default_rng(3)
    x = np.where(rng.random((5, 9, 40)) < 0.2, rng.normal(size=(5, 9, 40)), 0.0).astype(np.float32)
    for stack in (x, x[..., :12]):
        want = jfs.build_sparse_slab(stack, bucketer=ladder)
        got = tfs.build_sparse_slab(torch.from_numpy(stack), bucketer=ladder)
        assert got.idx.numpy().tobytes() == np.asarray(want.idx).tobytes()
        assert got.val.numpy().tobytes() == np.asarray(want.val).tobytes()
        assert got.max_nnz == want.max_nnz <= stack.shape[-1]
