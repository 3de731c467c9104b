"""Minimal pure-Python Avro: binary encoding + object container files (a
copy of photon_ml_tpu/io/avro.py: per-block retries and the corrupt-block
skip with its budget included).

The reference reads/writes all data and models as Avro on HDFS
(avro/AvroUtils.scala:43-270, AvroIOUtils.scala). This framework keeps the
same on-disk formats for drop-in compatibility, implemented from the public
Avro 1.x specification (binary encoding: zigzag-varint longs, little-endian
doubles, length-prefixed strings/bytes, block-encoded arrays/maps; container
file: "Obj\\x01" magic, metadata map with avro.schema/avro.codec, 16-byte
sync marker, data blocks of [count, size, payload, sync]).

Supports the subset the photon schemas use: record, array, map, union,
string, bytes, double, float, long, int, boolean, null, enum. Codecs: null
and deflate (zlib).

No external dependencies — works in the baked image (fastavro is absent).
"""

from __future__ import annotations

import io as _io
import json
import logging
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterable, Iterator, List, Optional, Union

from photon_ml_tpu_torch import resilience
from photon_ml_tpu_torch.resilience import faults

MAGIC = b"Obj\x01"
DEFAULT_SYNC = b"\x50\x48\x4f\x54\x4f\x4e\x2d\x54\x50\x55\x2d\x53\x59\x4e\x43\x21"  # 16B

Schema = Union[str, dict, list]

logger = logging.getLogger(__name__)

class CorruptBlockError(ValueError):
    """A container block failed to decode. Carries the file path, block
    index, and byte offset so a corrupt shard report is actionable (which
    part-file to quarantine, where to look with a hex editor)."""

    def __init__(self, path: str, block_index: int, offset: int, reason: str):
        self.path = path
        self.block_index = block_index
        self.offset = offset
        self.reason = reason
        super().__init__(
            f"{path}: corrupt avro block {block_index} at byte offset "
            f"{offset}: {reason}"
        )


# ---------------------------------------------------------------------------
# primitive encoders / decoders
# ---------------------------------------------------------------------------


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(buf: BinaryIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def read_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("unexpected end of avro data")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            return _zigzag_decode(acc)
        shift += 7


def write_bytes(buf: BinaryIO, data: bytes) -> None:
    write_long(buf, len(data))
    buf.write(data)


def read_bytes(buf: BinaryIO) -> bytes:
    n = read_long(buf)
    return buf.read(n)


def write_string(buf: BinaryIO, s: str) -> None:
    write_bytes(buf, s.encode("utf-8"))


def read_string(buf: BinaryIO) -> str:
    return read_bytes(buf).decode("utf-8")


# ---------------------------------------------------------------------------
# schema-driven datum encoding
# ---------------------------------------------------------------------------


def _resolve(schema: Schema, names: Dict[str, dict]) -> Schema:
    if isinstance(schema, str) and schema in names:
        return names[schema]
    return schema


def _register(schema: Schema, names: Dict[str, dict]) -> None:
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed"):
            names[schema["name"]] = schema
            full = schema.get("namespace", "") + "." + schema["name"]
            names[full.lstrip(".")] = schema
        if t == "record":
            for f in schema["fields"]:
                _register(f["type"], names)
        elif t == "array":
            _register(schema["items"], names)
        elif t == "map":
            _register(schema["values"], names)
    elif isinstance(schema, list):
        for s in schema:
            _register(s, names)


def write_datum(buf: BinaryIO, datum: Any, schema: Schema, names: Dict[str, dict]) -> None:
    schema = _resolve(schema, names)
    if isinstance(schema, list):  # union: pick first matching branch
        idx, branch = _match_union(datum, schema, names)
        write_long(buf, idx)
        write_datum(buf, datum, branch, names)
        return
    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return
    if t == "boolean":
        buf.write(b"\x01" if datum else b"\x00")
    elif t in ("int", "long"):
        write_long(buf, int(datum))
    elif t == "float":
        buf.write(struct.pack("<f", float(datum)))
    elif t == "double":
        buf.write(struct.pack("<d", float(datum)))
    elif t == "bytes":
        write_bytes(buf, datum)
    elif t == "string":
        write_string(buf, datum)
    elif t == "enum":
        write_long(buf, schema["symbols"].index(datum))
    elif t == "fixed":
        buf.write(datum)
    elif t == "array":
        if datum:
            write_long(buf, len(datum))
            for item in datum:
                write_datum(buf, item, schema["items"], names)
        write_long(buf, 0)
    elif t == "map":
        if datum:
            write_long(buf, len(datum))
            for k, v in datum.items():
                write_string(buf, k)
                write_datum(buf, v, schema["values"], names)
        write_long(buf, 0)
    elif t == "record":
        for f in schema["fields"]:
            name = f["name"]
            if name in datum:
                value = datum[name]
            elif "default" in f:
                value = f["default"]
            else:
                raise ValueError(f"missing field {name} for record {schema['name']}")
            write_datum(buf, value, f["type"], names)
    else:
        raise ValueError(f"unsupported schema type: {t}")


def _match_union(datum, union: list, names) -> tuple:
    for i, branch in enumerate(union):
        b = _resolve(branch, names)
        t = b["type"] if isinstance(b, dict) else b
        if datum is None and t == "null":
            return i, branch
        if datum is not None and t != "null":
            return i, branch
    raise ValueError(f"no union branch for {datum!r} in {union}")


def read_datum(buf: BinaryIO, schema: Schema, names: Dict[str, dict]) -> Any:
    schema = _resolve(schema, names)
    if isinstance(schema, list):
        idx = read_long(buf)
        return read_datum(buf, schema[idx], names)
    t = schema["type"] if isinstance(schema, dict) else schema
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return read_bytes(buf)
    if t == "string":
        return read_string(buf)
    if t == "enum":
        return schema["symbols"][read_long(buf)]
    if t == "fixed":
        return buf.read(schema["size"])
    if t == "array":
        out: List[Any] = []
        while True:
            count = read_long(buf)
            if count == 0:
                return out
            if count < 0:  # block with byte size prefix
                read_long(buf)
                count = -count
            for _ in range(count):
                out.append(read_datum(buf, schema["items"], names))
    if t == "map":
        res: Dict[str, Any] = {}
        while True:
            count = read_long(buf)
            if count == 0:
                return res
            if count < 0:
                read_long(buf)
                count = -count
            for _ in range(count):
                k = read_string(buf)
                res[k] = read_datum(buf, schema["values"], names)
    if t == "record":
        return {f["name"]: read_datum(buf, f["type"], names) for f in schema["fields"]}
    raise ValueError(f"unsupported schema type: {t}")


# ---------------------------------------------------------------------------
# object container files
# ---------------------------------------------------------------------------


def write_container(
    path: str,
    records: Iterable[Any],
    schema: Schema,
    codec: str = "deflate",
    block_size: int = 4096,
) -> None:
    names: Dict[str, dict] = {}
    _register(schema, names)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        meta = {
            "avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode(),
        }
        write_long(f, len(meta))
        for k, v in meta.items():
            write_string(f, k)
            write_bytes(f, v)
        write_long(f, 0)
        f.write(DEFAULT_SYNC)

        block = _io.BytesIO()
        count = 0

        def flush():
            nonlocal block, count
            if count == 0:
                return
            payload = block.getvalue()
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-4]  # raw deflate per spec
            write_long(f, count)
            write_bytes(f, payload)
            f.write(DEFAULT_SYNC)
            block = _io.BytesIO()
            count = 0

        for rec in records:
            write_datum(block, rec, schema, names)
            count += 1
            if count >= block_size:
                flush()
        flush()


def _resync(f: BinaryIO, sync: bytes, start: int) -> Optional[int]:
    """Scan forward from ``start`` for the next 16-byte sync marker; return
    the offset just past it (the next block start), or None at EOF. Reads in
    chunks with a 15-byte overlap so a marker straddling a chunk boundary is
    still found."""
    chunk_size = 1 << 16
    f.seek(start)
    carry = b""
    base = start
    while True:
        chunk = f.read(chunk_size)
        if not chunk:
            return None
        buf = carry + chunk
        hit = buf.find(sync)
        if hit >= 0:
            return base - len(carry) + hit + len(sync)
        carry = buf[-(len(sync) - 1):]
        base += len(chunk)


def read_container(
    path: str,
    on_corrupt: Optional[str] = None,
    skip_budget: Optional[int] = None,
) -> Iterator[Any]:
    """Iterate records of one container file.

    Transient read failures (OSError) are retried per block with the active
    :class:`~photon_ml_tpu_torch.resilience.RetryPolicy` — the file offset is
    remembered before each block so a retry re-reads exactly that block.

    ``on_corrupt="skip"`` drops undecodable blocks (resynchronizing on the
    sync marker) up to ``skip_budget`` blocks before raising; ``"raise"``
    (default) surfaces the first :class:`CorruptBlockError`. Both default to
    the process-wide resilience config.
    """
    cfg = resilience.current_config()
    if on_corrupt is None:
        on_corrupt = cfg.on_corrupt
    if on_corrupt not in resilience.ON_CORRUPT_MODES:
        raise ValueError(
            f"on_corrupt must be one of {resilience.ON_CORRUPT_MODES}, "
            f"got {on_corrupt!r}"
        )
    if skip_budget is None:
        skip_budget = cfg.corrupt_skip_budget
    policy = cfg.io_policy

    with resilience.call_with_retry(
        lambda: open(path, "rb"), policy, describe=f"open {path}"
    ) as f:

        def read_header():
            """Magic + metadata map + sync marker; seeks to 0 first so the
            enclosing retry (transient read errors mid-header) is idempotent."""
            f.seek(0)
            if f.read(4) != MAGIC:
                raise ValueError(f"{path}: not an avro container file")
            meta: Dict[str, bytes] = {}
            while True:
                count = read_long(f)
                if count == 0:
                    break
                if count < 0:
                    read_long(f)
                    count = -count
                for _ in range(count):
                    k = read_string(f)
                    meta[k] = read_bytes(f)
            return meta, f.read(16)

        meta, sync = resilience.call_with_retry(
            read_header, policy, describe=f"read {path} header"
        )
        schema = json.loads(meta["avro.schema"].decode())
        codec = meta.get("avro.codec", b"null").decode()
        if codec not in ("deflate", "null"):
            raise ValueError(f"unsupported codec {codec}")
        names: Dict[str, dict] = {}
        _register(schema, names)

        block_index = 0
        skipped = 0

        def read_block(offset: int, index: int) -> Optional[List[Any]]:
            """One complete block -> record list; None on clean EOF. Seeks
            back to ``offset`` first so the enclosing retry is idempotent;
            decode failures become CorruptBlockError (never retried —
            re-reading corrupt bytes cannot help)."""
            f.seek(offset)
            faults.inject("io.read_block", path=path, block=index, offset=offset)
            try:
                count = read_long(f)
            except EOFError:
                return None  # clean end of container
            try:
                payload = read_bytes(f)
                if codec == "deflate":
                    payload = zlib.decompress(payload, -15)
                block = _io.BytesIO(payload)
                records = [read_datum(block, schema, names) for _ in range(count)]
            except (EOFError, struct.error) as e:
                raise CorruptBlockError(
                    path, index, offset, f"unexpected end of avro data ({e})"
                ) from e
            except zlib.error as e:
                raise CorruptBlockError(
                    path, index, offset, f"deflate payload corrupt ({e})"
                ) from e
            except (ValueError, KeyError, IndexError, TypeError) as e:
                raise CorruptBlockError(
                    path, index, offset, f"datum decode failed ({e})"
                ) from e
            if f.read(16) != sync:
                raise CorruptBlockError(path, index, offset, "sync marker mismatch")
            return records

        while True:
            offset = f.tell()
            try:
                records = resilience.call_with_retry(
                    lambda: read_block(offset, block_index),
                    policy,
                    describe=f"read {path} block {block_index}",
                    on_retry=lambda a, e, d: logger.warning(
                        "retrying %s block %d (attempt %d): %s", path, block_index, a + 2, e
                    ),
                )
            except CorruptBlockError as err:
                if on_corrupt != "skip" or skipped >= skip_budget:
                    raise
                skipped += 1
                logger.warning(
                    "skipping corrupt block (%d/%d of skip budget): %s",
                    skipped, skip_budget, err,
                )
                next_off = _resync(f, sync, offset + 1)
                if next_off is None:
                    return  # no later sync marker: rest of the file is gone
                f.seek(next_off)
                block_index += 1
                continue
            if records is None:
                return
            yield from records
            block_index += 1


def list_part_files(path: str) -> list:
    """The ``*.avro`` part files of a directory, sorted (or the file): one
    definition shared by read_directory and the native path
    (io/avro_data._native_columns), so the two read the same files."""
    if os.path.isfile(path):
        return [path]
    return [
        os.path.join(path, name)
        for name in sorted(os.listdir(path))
        if name.endswith(".avro")
    ]


def read_directory(
    path: str,
    on_corrupt: Optional[str] = None,
    skip_budget: Optional[int] = None,
) -> Iterator[Any]:
    """Read all part files of an avro output directory (part-*.avro).
    ``on_corrupt``/``skip_budget`` apply per part file (read_container)."""
    for f in list_part_files(path):
        yield from read_container(f, on_corrupt=on_corrupt, skip_budget=skip_budget)
