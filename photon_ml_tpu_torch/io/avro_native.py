"""Python wrapper for the native Avro columnar decoder
(native/avro_decoder.cpp, shared with the JAX package; a port of
photon_ml_tpu/io/avro_native.py on this package's host build).

``iter_records(path)`` parses one container file through the C++ decoder
(block framing, raw-deflate, zigzag varints all native) and reconstructs
Python record dicts from the returned COLUMNS — byte-for-byte equal to
``io.avro.read_container`` for the supported schema shapes. Unsupported
shapes (bytes/fixed/enum fields, unions with multiple non-null value
branches, arrays of non-records...) return ``None`` so callers fall back to
the pure-Python codec, which remains the source of truth.

The library is built from the checkout's ``native/`` with g++ on first use
(``native_build.build_host``); a failed build raises. With
``PHOTON_ML_TPU_NATIVE=0`` every entry point returns ``None`` and callers
take the pure-Python codec.

Caveat: the native path carries long/int values as f64 internally;
the DECODER flags any long outside +/-2^53 and the whole file falls back
to the exact python codec, so id/label precision can never silently
degrade.
"""

from __future__ import annotations

import ctypes
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch import native_build
from photon_ml_tpu_torch.io.avro import MAGIC, _register, read_bytes, read_long, read_string

D_DOUBLE, D_FLOAT, D_LONG, D_INT = 0x01, 0x02, 0x03, 0x04
D_STRING, D_BOOL, D_NULL = 0x05, 0x06, 0x07
D_UNION, D_ARRAY, D_MAP, D_RECORD = 0x10, 0x20, 0x30, 0x40

_PRIMITIVE = {
    "double": D_DOUBLE,
    "float": D_FLOAT,
    "long": D_LONG,
    "int": D_INT,
    "string": D_STRING,
    "boolean": D_BOOL,
    "null": D_NULL,
}


def _load():
    """The decoder library, built on first use; None when
    ``PHOTON_ML_TPU_NATIVE=0`` asks for the pure-Python codec."""
    if not native_build.native_enabled():
        return None

    def configure(lib):
        lib.avd_parse.restype = ctypes.c_void_p
        lib.avd_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.avd_num_records.restype = ctypes.c_long
        lib.avd_num_records.argtypes = [ctypes.c_void_p]
        lib.avd_error.restype = ctypes.c_char_p
        lib.avd_error.argtypes = [ctypes.c_void_p]
        lib.avd_free.restype = None
        lib.avd_free.argtypes = [ctypes.c_void_p]
        upath = ctypes.POINTER(ctypes.c_uint32)
        for f in (
            lib.avd_col_size_nums, lib.avd_col_size_heap,
            lib.avd_col_size_counts, lib.avd_col_size_kheap,
            lib.avd_col_size_offsets, lib.avd_col_size_present,
            lib.avd_col_size_koffsets, lib.avd_col_size_kinds,
        ):
            f.restype = ctypes.c_long
            f.argtypes = [ctypes.c_void_p, upath, ctypes.c_long]
        lib.avd_col_fetch_kinds.restype = ctypes.c_int
        lib.avd_col_fetch_kinds.argtypes = [
            ctypes.c_void_p, upath, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.avd_col_fetch.restype = ctypes.c_int
        lib.avd_col_fetch.argtypes = [
            ctypes.c_void_p, upath, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]

    return native_build.load_host("avro_decoder.cpp", configure, libs=("-lz",))


def _resolve(schema, names: Dict[str, Any]):
    if isinstance(schema, str) and schema in names:
        return names[schema]
    return schema


def _build_descriptor(schema, names: Dict[str, Any], out: bytearray) -> bool:
    """schema dict -> wire descriptor; False when unsupported."""
    schema = _resolve(schema, names)
    if isinstance(schema, str):
        code = _PRIMITIVE.get(schema)
        if code is None:
            return False
        out.append(code)
        return True
    if isinstance(schema, list):  # union
        if len(schema) > 255:
            return False
        out.append(D_UNION)
        out.append(len(schema))
        for branch in schema:
            if not _build_descriptor(branch, names, out):
                return False
        return True
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in _PRIMITIVE:
            out.append(_PRIMITIVE[t])
            return True
        if t == "record":
            fields = schema.get("fields", [])
            if len(fields) > 255:
                return False
            out.append(D_RECORD)
            out.append(len(fields))
            for f in fields:
                if not _build_descriptor(f["type"], names, out):
                    return False
            return True
        if t == "array":
            out.append(D_ARRAY)
            return _build_descriptor(schema["items"], names, out)
        if t == "map":
            out.append(D_MAP)
            value_desc = bytearray()
            if not _build_descriptor(schema["values"], names, value_desc):
                return False
            # map values ride the child node's scalar columns; only
            # string/primitive values are supported
            if value_desc[0] not in (
                D_DOUBLE, D_FLOAT, D_LONG, D_INT, D_STRING, D_BOOL,
            ):
                return False
            out.extend(value_desc)
            return True
    return False  # enum / fixed / bytes / unknown


class _Handle:
    def __init__(self, lib, h):
        self.lib, self.h = lib, h

    def __del__(self):
        try:
            if self.h:
                self.lib.avd_free(self.h)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def _path(self, path: Sequence[int]):
        arr = (ctypes.c_uint32 * len(path))(*path)
        return arr, len(path)

    def fetch(self, path: Sequence[int]):
        """-> dict of whichever columns the node carries."""
        lib = self.lib
        arr, n = self._path(path)
        n_nums = lib.avd_col_size_nums(self.h, arr, n)
        n_heap = lib.avd_col_size_heap(self.h, arr, n)
        n_counts = lib.avd_col_size_counts(self.h, arr, n)
        n_kheap = lib.avd_col_size_kheap(self.h, arr, n)
        n_offsets = lib.avd_col_size_offsets(self.h, arr, n)
        n_present = lib.avd_col_size_present(self.h, arr, n)
        n_koffsets = lib.avd_col_size_koffsets(self.h, arr, n)
        n_kinds = lib.avd_col_size_kinds(self.h, arr, n)
        if min(n_nums, n_heap, n_counts, n_kheap, n_offsets, n_present,
               n_koffsets, n_kinds) < 0:
            raise ValueError("bad column path")
        nums = np.empty(max(n_nums, 1), np.float64)
        present = np.empty(max(n_present, 1), np.uint8)
        heap = np.empty(max(n_heap, 1), np.uint8)
        counts = np.empty(max(n_counts, 1), np.int64)
        kheap = np.empty(max(n_kheap, 1), np.uint8)
        offsets = np.zeros(n_offsets + 1, np.int64)
        koffsets = np.zeros(n_koffsets + 1, np.int64)
        kinds = np.empty(max(n_kinds, 1), np.uint8)
        lib.avd_col_fetch_kinds(
            self.h, arr, n,
            kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        lib.avd_col_fetch(
            self.h, arr, n,
            nums.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            present.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            heap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets[1:].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            kheap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            koffsets[1:].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return {
            "nums": nums[:n_nums],
            "present": present[:n_present],
            "heap": heap[:n_heap].tobytes(),
            "offsets": offsets,
            "counts": counts[:n_counts],
            "kheap": kheap[:n_kheap].tobytes(),
            "koffsets": koffsets,
            "kinds": kinds[:n_kinds],
        }


def _parse_file(path: str, descriptor: bytes) -> Optional[Tuple[_Handle, int]]:
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    h = lib.avd_parse(data, len(data), bytes(descriptor), len(descriptor))
    if not h:
        return None
    handle = _Handle(lib, h)
    err = lib.avd_error(h)
    if err:
        return None  # fallback (unsupported codec/shape or corrupt)
    return handle, int(lib.avd_num_records(h))


def _strings(heap: bytes, offsets: np.ndarray, count: int) -> List[str]:
    return [
        heap[offsets[i]:offsets[i + 1]].decode("utf-8") for i in range(count)
    ]


def _scalar_value(code: int, v: float):
    if code in (D_LONG, D_INT):
        return int(v)
    if code == D_BOOL:
        return bool(v)
    return float(v)


def _read_schema_and_descriptor(path: str):
    """Container header -> (resolved record schema, names, descriptor), or
    None when the file/schema can't take the native path. The ONE preamble
    shared by iter_records and read_columns."""
    try:
        with open(path, "rb") as f:
            if f.read(4) != MAGIC:
                return None
            meta = {}
            while True:
                cnt = read_long(f)
                if cnt == 0:
                    break
                if cnt < 0:
                    read_long(f)
                    cnt = -cnt
                for _ in range(cnt):
                    k = read_string(f)
                    meta[k] = read_bytes(f)
        schema = json.loads(meta["avro.schema"].decode())
    except Exception:  # noqa: BLE001 — any malformed header degrades to the pure-Python reader
        return None
    names: Dict[str, Any] = {}
    _register(schema, names)
    schema = _resolve(schema, names)
    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        return None
    desc = bytearray()
    if not _build_descriptor(schema, names, desc):
        return None
    return schema, names, bytes(desc)


def iter_records(path: str) -> Optional[List[dict]]:
    """Decode one container file natively; None -> caller falls back."""
    pre = _read_schema_and_descriptor(path)
    if pre is None:
        return None
    schema, names, desc = pre
    parsed = _parse_file(path, desc)
    if parsed is None:
        return None
    handle, n_records = parsed

    fields = schema["fields"]
    columns: List[Tuple[str, Any]] = []
    try:
        for fi, field in enumerate(fields):
            columns.append((field["name"], _materialize(
                handle, (fi,), _resolve(field["type"], names), names, n_records
            )))
    except _Unsupported:
        return None
    return [
        {name: col(i) for name, col in columns} for i in range(n_records)
    ]


class _Unsupported(Exception):
    pass


def _materialize(handle: _Handle, path: Tuple[int, ...], schema, names, n: int):
    """-> callable(record_index) producing the field's python value."""
    schema = _resolve(schema, names)
    if isinstance(schema, dict) and schema.get("type") in _PRIMITIVE:
        schema = schema["type"]
    if isinstance(schema, str):
        code = _PRIMITIVE[schema]
        col = handle.fetch(path)
        if code == D_STRING:
            strs = _strings(col["heap"], col["offsets"], n)
            return lambda i: strs[i]
        if code == D_NULL:
            return lambda i: None
        nums = col["nums"]
        return lambda i, c=code: _scalar_value(c, nums[i])
    if isinstance(schema, list):  # union: kinds = chosen branch per entry
        branches = [_resolve(b, names) for b in schema]
        # primitive dicts like {"type": "double"} normalize to their name
        branches = [
            b["type"] if isinstance(b, dict) and b.get("type") in _PRIMITIVE else b
            for b in branches
        ]
        col = handle.fetch(path)
        kinds = col["kinds"]
        nums = col["nums"]
        is_string = np.asarray(
            [isinstance(b, str) and b == "string" for b in branches], bool
        )
        str_mask = is_string[kinds] if len(kinds) else np.zeros(0, bool)
        n_strings = int(str_mask.sum())
        strs = _strings(col["heap"], col["offsets"], n_strings)
        # entry -> rank among string entries (valid only where str_mask)
        str_rank = np.cumsum(str_mask) - 1
        getters = {}
        for bi, b in enumerate(branches):
            if isinstance(b, str) and b == "null":
                getters[bi] = lambda i: None
            elif isinstance(b, str) and b in (
                "double", "float", "long", "int", "boolean"
            ):
                code = _PRIMITIVE[b]
                getters[bi] = lambda i, c=code: _scalar_value(c, nums[i])
            elif isinstance(b, str) and b == "string":
                getters[bi] = lambda i: strs[int(str_rank[i])]
            elif isinstance(b, dict) and b.get("type") in ("map", "array", "record"):
                present_b = (kinds == bi).astype(np.uint8)
                getters[bi] = _materialize_sparse(
                    handle, path + (bi,), b, names, present_b
                )
            else:
                raise _Unsupported()
        return lambda i: getters[int(kinds[i])](i)
    if isinstance(schema, dict) and schema.get("type") == "array":
        item = _resolve(schema["items"], names)
        if not (isinstance(item, dict) and item.get("type") == "record"):
            raise _Unsupported()
        col = handle.fetch(path)
        counts = col["counts"]
        starts = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        total = int(starts[-1])
        fnames = [f["name"] for f in item["fields"]]
        # recurse per field over the FLATTENED item axis — unions, nested
        # records etc. come along for free
        fgetters = [
            _materialize(handle, path + (0, fj), f["type"], names, total)
            for fj, f in enumerate(item["fields"])
        ]

        def get_array(i):
            s, e = int(starts[i]), int(starts[i + 1])
            return [
                {nm: g(j) for nm, g in zip(fnames, fgetters)}
                for j in range(s, e)
            ]

        return get_array
    if isinstance(schema, dict) and schema.get("type") == "map":
        vt = _resolve(schema["values"], names)
        if not (isinstance(vt, str) and vt == "string"):
            raise _Unsupported()
        col = handle.fetch(path)
        counts = col["counts"]
        starts = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        total = int(starts[-1])
        keys = _strings(col["kheap"], col["koffsets"], total)
        vcol = handle.fetch(path + (0,))
        vals = _strings(vcol["heap"], vcol["offsets"], total)

        def get_map(i):
            s, e = starts[i], starts[i + 1]
            return {keys[j]: vals[j] for j in range(s, e)}

        return get_map
    raise _Unsupported()


def _materialize_sparse(handle, path, schema, names, present):
    """Union branch whose values exist only for ``present`` records (the
    child node holds one entry per PRESENT record)."""
    schema = _resolve(schema, names)
    dense_index = np.cumsum(present.astype(np.int64)) - 1  # record -> child row
    n_present = int(present.sum())
    if isinstance(schema, dict) and schema.get("type") == "map":
        inner = _materialize(handle, path, schema, names, n_present)
        return lambda i: inner(int(dense_index[i])) if present[i] else None
    if isinstance(schema, dict) and schema.get("type") == "array":
        inner = _materialize(handle, path, schema, names, n_present)
        return lambda i: inner(int(dense_index[i])) if present[i] else None
    raise _Unsupported()


# ---------------------------------------------------------------------------
# columnar API — the ingest fast path proper. iter_records() above rebuilds
# python dicts (wire decode native, materialization still python-bound);
# NativeColumns hands the raw columns to vectorized consumers
# (io/avro_data.py) so ingest never touches per-record python objects.
# ---------------------------------------------------------------------------


class NativeColumns:
    """Columnar view of one parsed container file."""

    def __init__(self, handle: _Handle, n: int, schema: dict, names: dict):
        self._h = handle
        self.n = n
        self._names = names
        self._fields = {f["name"]: (fi, _resolve(f["type"], names))
                        for fi, f in enumerate(schema["fields"])}

    def has_field(self, name: str) -> bool:
        return name in self._fields

    def field_type(self, name: str):
        """Resolved (normalized) declared type of a field, or None."""
        if name not in self._fields:
            return None
        return self._norm(self._fields[name][1])

    def _norm(self, t):
        t = _resolve(t, self._names)
        if isinstance(t, dict) and t.get("type") in _PRIMITIVE:
            return t["type"]
        return t

    def scalar(self, name: str):
        """-> (values f64, present u8) for numeric/bool fields, incl. via
        union; None when the field isn't scalar-shaped."""
        if name not in self._fields:
            return None
        fi, t = self._fields[name]
        t = self._norm(t)
        col = self._h.fetch((fi,))
        if isinstance(t, str) and t in ("double", "float", "long", "int", "boolean"):
            return col["nums"], np.ones(self.n, np.uint8)
        if isinstance(t, list):
            branches = [self._norm(b) for b in t]
            scalarish = np.asarray([
                isinstance(b, str) and b in (
                    "null", "double", "float", "long", "int", "boolean",
                )
                for b in branches
            ], bool)
            if scalarish.all():
                return col["nums"], col["present"]
            # mixed union (e.g. yahoo's [double,...,string] response): usable
            # iff no record ACTUALLY chose a non-scalar branch
            kinds = col["kinds"]
            if len(kinds) == self.n and scalarish[kinds].all():
                return col["nums"], col["present"]
        return None

    def strings(self, name: str):
        """-> (list[str|None], present) for string fields (incl. union with
        null); None if not string-shaped."""
        if name not in self._fields:
            return None
        fi, t = self._fields[name]
        t = self._norm(t)
        col = self._h.fetch((fi,))
        if isinstance(t, str) and t == "string":
            return _strings(col["heap"], col["offsets"], self.n), np.ones(self.n, np.uint8)
        if isinstance(t, list):
            branches = [self._norm(b) for b in t]
            if all(isinstance(b, str) and b in ("null", "string") for b in branches):
                kinds = col["kinds"]
                is_str = np.asarray([b == "string" for b in branches], bool)
                mask = is_str[kinds].astype(np.uint8) if len(kinds) else np.zeros(0, np.uint8)
                vals = _strings(col["heap"], col["offsets"], int(mask.sum()))
                rank = np.cumsum(mask) - 1
                out = [vals[int(rank[i])] if mask[i] else None for i in range(self.n)]
                return out, mask
        return None

    def ntv_array(self, name: str):
        """-> (counts i64, names list[str], terms list[str], values f64) for
        an array of NameTermValue-shaped records (term may be a
        (null,string) union: a null term renders as the python codec does
        through feature_key — the literal string "None").

        None when the field isn't shaped like that."""
        if name not in self._fields:
            return None
        fi, t = self._fields[name]
        t = self._norm(t)
        if not (isinstance(t, dict) and t.get("type") == "array"):
            return None
        item = _resolve(t["items"], self._names)
        if not (isinstance(item, dict) and item.get("type") == "record"):
            return None
        sub = {f["name"]: (fj, self._norm(f["type"])) for fj, f in enumerate(item["fields"])}
        if not {"name", "value"} <= set(sub):
            return None
        col = self._h.fetch((fi,))
        counts = col["counts"]
        total = int(counts.sum())

        nj, nt = sub["name"]
        if nt != "string":
            return None
        ncol = self._h.fetch((fi, 0, nj))
        names_l = _strings(ncol["heap"], ncol["offsets"], total)

        vj, vt = sub["value"]
        if vt not in ("double", "float", "long", "int"):
            return None
        values = self._h.fetch((fi, 0, vj))["nums"][:total]

        if "term" in sub:
            tj, tt = sub["term"]
            tcol = self._h.fetch((fi, 0, tj))
            if tt == "string":
                terms_l = _strings(tcol["heap"], tcol["offsets"], total)
            elif isinstance(tt, list) and all(
                isinstance(b, str) and b in ("null", "string") for b in tt
            ):
                kinds = tcol["kinds"]
                is_str = np.asarray([b == "string" for b in (tt)], bool)
                mask = is_str[kinds] if len(kinds) else np.zeros(0, bool)
                vals = _strings(tcol["heap"], tcol["offsets"], int(mask.sum()))
                rank = np.cumsum(mask) - 1
                # feature_key(name, None) stringifies None — keep that exact
                terms_l = [
                    vals[int(rank[i])] if mask[i] else "None" for i in range(total)
                ]
            else:
                return None
        else:
            terms_l = [""] * total
        return counts, names_l, terms_l, values

    def ntv_array_raw(self, name: str):
        """Raw-bytes variant of :meth:`ntv_array` — no per-item python
        strings (the columnar ingest builds keys vectorized on the heaps).

        -> dict(counts, values, name_heap, name_off, term) where term is
        ("strings", heap, off) | ("union", heap, off_str_only, str_mask)
        | ("empty",); None when unsupported."""
        if name not in self._fields:
            return None
        fi, t = self._fields[name]
        t = self._norm(t)
        if not (isinstance(t, dict) and t.get("type") == "array"):
            return None
        item = _resolve(t["items"], self._names)
        if not (isinstance(item, dict) and item.get("type") == "record"):
            return None
        sub = {f["name"]: (fj, self._norm(f["type"])) for fj, f in enumerate(item["fields"])}
        if not {"name", "value"} <= set(sub):
            return None
        counts = self._h.fetch((fi,))["counts"]
        total = int(counts.sum())
        nj, nt = sub["name"]
        if nt != "string":
            return None
        ncol = self._h.fetch((fi, 0, nj))
        vj, vt = sub["value"]
        if vt not in ("double", "float", "long", "int"):
            return None
        values = self._h.fetch((fi, 0, vj))["nums"][:total]
        if "term" in sub:
            tj, tt = sub["term"]
            tcol = self._h.fetch((fi, 0, tj))
            if tt == "string":
                term = ("strings", tcol["heap"], tcol["offsets"])
            elif isinstance(tt, list) and all(
                isinstance(b, str) and b in ("null", "string") for b in tt
            ):
                kinds = tcol["kinds"]
                is_str = np.asarray([b == "string" for b in tt], bool)
                mask = is_str[kinds] if len(kinds) else np.zeros(0, bool)
                term = ("union", tcol["heap"], tcol["offsets"], mask)
            else:
                return None
        else:
            term = ("empty",)
        return {
            "counts": counts,
            "values": values,
            "name_heap": ncol["heap"],
            "name_off": ncol["offsets"],
            "term": term,
            "total": total,
        }

    def string_map(self, name: str):
        """-> (counts per PRESENT record, keys, values, present mask) for a
        map<string> field (possibly union with null); None otherwise."""
        if name not in self._fields:
            return None
        fi, t = self._fields[name]
        t = self._norm(t)
        col = self._h.fetch((fi,))
        if isinstance(t, dict) and t.get("type") == "map":
            present = np.ones(self.n, np.uint8)
            mpath = (fi,)
        elif isinstance(t, list):
            branches = [self._norm(b) for b in t]
            map_branches = [
                (bi, b) for bi, b in enumerate(branches)
                if isinstance(b, dict) and b.get("type") == "map"
            ]
            if len(map_branches) != 1 or not all(
                (isinstance(b, str) and b == "null") or
                (isinstance(b, dict) and b.get("type") == "map")
                for b in branches
            ):
                return None
            bi, b = map_branches[0]
            present = (col["kinds"] == bi).astype(np.uint8)
            t = b
            mpath = (fi, bi)
        else:
            return None
        if self._norm(t["values"]) != "string":
            return None
        mcol = self._h.fetch(mpath)
        counts = mcol["counts"]
        total = int(counts.sum())
        keys = _strings(mcol["kheap"], mcol["koffsets"], total)
        vcol = self._h.fetch(mpath + (0,))
        vals = _strings(vcol["heap"], vcol["offsets"], total)
        return counts, keys, vals, present


def read_columns(path: str) -> Optional[NativeColumns]:
    """Parse one container file into a NativeColumns view, or None when the
    native decoder is unavailable or the schema shape is unsupported."""
    pre = _read_schema_and_descriptor(path)
    if pre is None:
        return None
    schema, names, desc = pre
    parsed = _parse_file(path, desc)
    if parsed is None:
        return None
    handle, n = parsed
    return NativeColumns(handle, n, schema, names)
