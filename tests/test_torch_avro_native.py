"""The port's native Avro ingest against the JAX package and its own row
loop (CPU): ``avro_native.read_columns`` column for column against the JAX
decoder on the generators of tests/test_avro_native.py; ``read_game_data``,
``read_training_examples``, ``collect_feature_keys`` and
``collect_shard_feature_keys`` (one parse for every shard, and one for the
scan and the dataset read inside ``reuse_parses``) native, through the
port's Python row loop (``PHOTON_ML_TPU_NATIVE=0``) and through the JAX
package, byte-equal; a file the decoder rejects is logged, counted and read
by the row loop; a failed host build raises instead of falling back.
"""

import logging

import numpy as np
import pytest

from photon_ml_tpu.io import avro_data as javro_data
from photon_ml_tpu.io import avro_native as javro_native
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.io import avro as tavro
from photon_ml_tpu_torch.io import avro_data as tavro_data
from photon_ml_tpu_torch.io import avro_native as tavro_native
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.index_map import IndexMap, feature_key
from test_avro_native import TRAIN_SCHEMA, _train_records

ID_FIELD_SCHEMA = {
    "name": "Y", "namespace": "t", "type": "record", "fields": [
        {"name": "userId", "type": "int"},
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": schemas.FEATURE}},
    ],
}


def _write(tmp_path, recs, schema=TRAIN_SCHEMA, parts=2):
    d = tmp_path / "data"
    d.mkdir(exist_ok=True)
    step = (len(recs) + parts - 1) // parts
    for i in range(parts):
        tavro.write_container(str(d / f"part-{i}.avro"), recs[i * step:(i + 1) * step], schema)
    return str(d)


def _with_ids(recs):
    for i, r in enumerate(recs):
        if r["metadataMap"] is None:
            r["metadataMap"] = {"userId": f"user{i % 5}"}
    return recs


def _row_loop(monkeypatch, fn, *args, **kwargs):
    with monkeypatch.context() as m:
        m.setenv(native_build.NATIVE_ENV, "0")
        return fn(*args, **kwargs)


def _assert_same_game_data(a, b):
    for f in ("response", "offset", "weight"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert a.id_vocabs == b.id_vocabs
    assert sorted(a.ids) == sorted(b.ids)
    for t in a.ids:
        assert a.ids[t].dtype == b.ids[t].dtype and a.ids[t].tobytes() == b.ids[t].tobytes()
    assert sorted(a.shards) == sorted(b.shards)
    for s in a.shards:
        for f in ("indptr", "indices", "values"):
            x, y = getattr(a.shards[s], f), getattr(b.shards[s], f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (s, f)
        assert a.shards[s].dim == b.shards[s].dim


def test_read_columns_match_the_jax_decoder(tmp_path):
    path = str(tmp_path / "t.avro")
    tavro.write_container(path, _train_records(), TRAIN_SCHEMA)
    got, want = tavro_native.read_columns(path), javro_native.read_columns(path)
    assert got is not None and want is not None and got.n == want.n == 300
    for name in ("label", "offset", "weight", "count", "flag"):
        for g, w in zip(got.scalar(name), want.scalar(name)):
            assert g.tobytes() == w.tobytes(), name
    assert got.strings("uid")[0] == want.strings("uid")[0]
    for g, w in zip(got.ntv_array("features"), want.ntv_array("features")):
        assert (g.tobytes() == w.tobytes()) if isinstance(g, np.ndarray) else g == w
    gm, wm = got.string_map("metadataMap"), want.string_map("metadataMap")
    assert gm[1:3] == wm[1:3] and gm[0].tobytes() == wm[0].tobytes()
    assert tavro_native.iter_records(path) == list(tavro.read_container(path))


@pytest.mark.parametrize("parts", [1, 3])
def test_read_game_data_native_row_loop_and_jax_are_byte_equal(tmp_path, monkeypatch, parts):
    d = _write(tmp_path, _with_ids(_train_records(seed=parts)), parts=parts)
    keys = tavro_data.collect_feature_keys([d])
    assert keys == _row_loop(monkeypatch, tavro_data.collect_feature_keys, [d])
    assert keys == javro_data.collect_feature_keys([d])
    maps = {"global": IndexMap.build(keys, add_intercept=True),
            "nointercept": IndexMap.build(keys[::2], add_intercept=False)}
    jmaps = {"global": JIndexMap.build(keys, add_intercept=True),
             "nointercept": JIndexMap.build(keys[::2], add_intercept=False)}
    sections = {"global": ["features"], "nointercept": ["features"]}
    before = dict(tavro_data.ingest_counts)
    native = tavro_data.read_game_data([d], maps, sections, ["userId"])
    assert tavro_data.ingest_counts["native_files"] == before["native_files"] + parts
    assert tavro_data.ingest_counts["row_loop_files"] == before["row_loop_files"]
    loop = _row_loop(monkeypatch, tavro_data.read_game_data, [d], maps, sections, ["userId"])
    assert tavro_data.ingest_counts["row_loop_files"] == before["row_loop_files"] + parts
    _assert_same_game_data(native, loop)
    _assert_same_game_data(native, javro_data.read_game_data([d], jmaps, sections, ["userId"]))


def test_read_game_data_id_field_and_vocab_reuse(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    recs = [{"userId": int(rng.integers(0, 20)), "response": float(rng.normal()),
             "features": [{"name": "a", "term": "", "value": float(rng.normal())}]}
            for _ in range(100)]
    d = _write(tmp_path, recs, ID_FIELD_SCHEMA, parts=1)
    maps = {"g": IndexMap.build([feature_key("a", "")], add_intercept=True)}
    jmaps = {"g": JIndexMap.build([feature_key("a", "")], add_intercept=True)}
    vocab = {"userId": ["1", "2", "3"]}
    args = ([d], maps, {"g": ["features"]}, ["userId"])
    native = tavro_data.read_game_data(*args, id_vocabs=vocab)
    assert (native.ids["userId"] == -1).any()
    _assert_same_game_data(native, _row_loop(monkeypatch, tavro_data.read_game_data, *args,
                                             id_vocabs=vocab))
    _assert_same_game_data(native, javro_data.read_game_data(
        [d], jmaps, {"g": ["features"]}, ["userId"], id_vocabs=vocab))


@pytest.mark.parametrize("add_intercept", [True, False])
def test_read_training_examples_native_row_loop_and_jax_are_byte_equal(
        tmp_path, monkeypatch, add_intercept):
    d = _write(tmp_path, _train_records(seed=5))
    keys = tavro_data.collect_feature_keys([d])
    imap, jmap = IndexMap.build(keys[1:]), JIndexMap.build(keys[1:])
    native = tavro_data.read_training_examples([d], imap, add_intercept)
    loop = _row_loop(monkeypatch, tavro_data.read_training_examples, [d], imap, add_intercept)
    want = javro_data.read_training_examples([d], jmap, add_intercept)
    for got in (native, loop):
        for f in ("labels", "indptr", "indices", "values", "offsets", "weights"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
        assert got.dim == want.dim


TWO_SECTION_SCHEMA = {
    "name": "S", "namespace": "t", "type": "record", "fields": [
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": schemas.FEATURE}},
        {"name": "userFeatures", "type": {"type": "array", "items": {
            "type": "record", "name": "UserFeatureAvro", "fields": schemas.FEATURE["fields"]}}},
    ],
}


def _two_section_records(n=120, seed=4):
    rng = np.random.default_rng(seed)
    feats = lambda prefix, k: [{"name": f"{prefix}{j}", "term": "t" if j % 3 else "",
                                "value": float(rng.normal())}
                               for j in rng.choice(12, k, replace=False)]
    return [{"response": float(i % 2), "features": feats("f", 4),
             "userFeatures": feats("u", 3)} for i in range(n)]


def _count_parses(monkeypatch):
    reads = []
    real = tavro_native.read_columns
    monkeypatch.setattr(tavro_native, "read_columns", lambda path: reads.append(path) or real(path))
    return reads


def test_one_read_gives_every_shards_keys(tmp_path, monkeypatch):
    """collect_shard_feature_keys parses each part file once for all the
    shards; each shard's keys are collect_feature_keys' of its sections,
    natively, through the row loop and through the JAX package."""
    d = _write(tmp_path, _two_section_records(), TWO_SECTION_SCHEMA, parts=3)
    shards = {"global": ["features", "userFeatures"], "per_user": ["userFeatures"],
              "absent": ["noSuchSection"]}
    loop = _row_loop(monkeypatch, tavro_data.collect_shard_feature_keys, [d], shards)
    reads = _count_parses(monkeypatch)
    got = tavro_data.collect_shard_feature_keys([d], shards)
    assert len(reads) == 3
    assert got == loop
    for shard, sections in shards.items():
        assert got[shard] == javro_data.collect_feature_keys([d], sections)
    assert got["absent"] == [] and set(got["per_user"]) < set(got["global"])


def test_reuse_parses_parses_a_file_once_inside_the_scope(tmp_path, monkeypatch):
    """Inside ``reuse_parses`` the vocabulary scan's parses feed the dataset
    read (the same bytes as a read outside the scope); a file rewritten
    inside the scope is parsed again, and outside it every read parses."""
    d = _write(tmp_path, _with_ids(_train_records(seed=7)))
    keys = tavro_data.collect_feature_keys([d])
    maps, sections = {"g": IndexMap.build(keys)}, {"g": ["features"]}
    reads = _count_parses(monkeypatch)
    with tavro_data.reuse_parses():
        assert tavro_data.collect_feature_keys([d]) == keys
        inside = tavro_data.read_game_data([d], maps, sections, ["userId"])
        assert len(reads) == 2  # two part files, each parsed once
        part = f"{d}/part-0.avro"
        recs = _with_ids(_train_records(seed=8))[:40]
        tavro.write_container(part, recs, TRAIN_SCHEMA)
        tavro_data.collect_feature_keys([d])
        assert reads[2:] == [part]
    assert tavro_data._reused_parses is None
    _write(tmp_path, _with_ids(_train_records(seed=7)))
    outside = tavro_data.read_game_data([d], maps, sections, ["userId"])
    assert len(reads) == 5
    _assert_same_game_data(inside, outside)


@pytest.mark.parametrize("collide", [False, True])
def test_key_dedupe_groups_rows_as_a_sort_of_their_bytes(monkeypatch, collide):
    """_unique_rows groups a matrix's rows as np.unique over their bytes
    does, through the hashes, and through the byte sort when every hash
    collides."""
    rng = np.random.default_rng(11)
    mat = rng.integers(0, 3, size=(5000, 13), dtype=np.uint8)  # many repeated rows
    if collide:
        monkeypatch.setattr(tavro_data, "_row_hashes", lambda m: np.zeros(len(m), np.uint64))
    first, inverse = tavro_data._unique_rows(mat)
    rows = mat.view(np.dtype((np.void, 13))).ravel()
    _, want_inverse = np.unique(rows, return_inverse=True)
    assert np.array_equal(mat[first[inverse]], mat)
    assert len(first) == len(set(rows.tolist())) == want_inverse.max() + 1
    # the same partition of the rows: equal groups here are equal groups there
    pairs = set(zip(inverse.reshape(-1).tolist(), want_inverse.reshape(-1).tolist()))
    assert len(pairs) == len(first)


def test_a_rejected_file_is_logged_counted_and_read_by_the_row_loop(tmp_path, caplog):
    # an enum field: the decoder has no descriptor for it, the row loop reads it
    schema = {**TRAIN_SCHEMA, "fields": TRAIN_SCHEMA["fields"] + [
        {"name": "kind", "type": {"name": "K", "type": "enum", "symbols": ["A", "B"]}}]}
    recs = [dict(r, kind="AB"[i % 2]) for i, r in enumerate(_with_ids(_train_records(80)))]
    d = _write(tmp_path, recs, schema)
    assert tavro_native.read_columns(f"{d}/part-0.avro") is None
    imap = {"g": IndexMap.build(tavro_data.collect_feature_keys([d]))}
    before = dict(tavro_data.ingest_counts)
    with caplog.at_level(logging.WARNING, logger=tavro_data.__name__):
        got = tavro_data.read_game_data([d], imap, {"g": ["features"]}, ["userId"])
    assert "native decoder rejected" in caplog.text and "part-0.avro" in caplog.text
    assert tavro_data.ingest_counts["rejected_files"] == before["rejected_files"] + 1
    assert tavro_data.ingest_counts["row_loop_files"] == before["row_loop_files"] + 2
    assert tavro_data.ingest_counts["native_files"] == before["native_files"]
    assert got.num_rows == 80


def test_a_failed_host_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    d = _write(tmp_path, _with_ids(_train_records(20)), parts=1)
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_build, "_loaded", {})
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    before = dict(tavro_data.ingest_counts)
    with pytest.raises(RuntimeError, match="g..? failed on native/avro_decoder.cpp"):
        tavro_data.read_game_data([d], {"g": IndexMap.build(["f1\x01"])},
                                  {"g": ["features"]}, ["userId"])
    assert tavro_data.ingest_counts == before
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_build.build_host("libsvm_parser.cpp")
    # asked for explicitly, the row loop needs no compiler
    monkeypatch.setenv(native_build.NATIVE_ENV, "0")
    assert tavro_data.read_game_data([d], {"g": IndexMap.build(["f1\x01"])},
                                     {"g": ["features"]}, ["userId"]).num_rows == 20
