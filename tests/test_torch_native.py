"""The port's native plain-JSON ingest lane against the JAX package, on the CPU.

The port's ladder has three tiers — columnar (one C++ pass into Arrow
buffers, optionally sharded), NDJSON (C++ flatten -> pyarrow's reader) and
Python — and each must stage the same table, for any body, as the JAX
package's `flatten_and_push_logs` does. Every test here is differential:
the same body goes through the port (its default ladder, the NDJSON tier
forced, the Python lane) and through the JAX package, and the staged rows,
without `p_timestamp`, must be equal, schema and values, with no tolerance.

The JAX side runs its Python lane: its native `flatten_columnar` and
`flatten_ndjson` are monkeypatched to decline, and its library loader to
find nothing, so this file never builds or loads the JAX package's native
library (a fresh checkout builds that one in place, and xdist workers that
load it at once can race). That lane is the JAX package's reference for its
own native tiers.

The port's library needs only g++: `native.load()` builds it into
`build/native/` at first use. Shard counts are forced with `shards=`; the
tables they give must be byte-identical in Arrow IPC.
"""

from __future__ import annotations

import gc
import io
import json
import random
from types import SimpleNamespace

import pyarrow as pa
import pyarrow.ipc as ipc
import pytest

import parseable_tpu.native as jax_native
from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.config import StorageOptions as JaxStorageOptions
from parseable_tpu.core import Parseable as JaxParseable
from parseable_tpu.event.format import LogSource as JaxLogSource
from parseable_tpu.server.ingest_utils import IngestError as JaxIngestError
from parseable_tpu.server.ingest_utils import flatten_and_push_logs as jax_ingest
from parseable_tpu.utils.flatten import has_more_than_max_allowed_levels as jax_too_deep
from parseable_tpu_torch import native
from parseable_tpu_torch.config import Options, StorageOptions
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.event.format import LogSource
from parseable_tpu_torch.server import ingest_utils as IU
from parseable_tpu_torch.staging.writer import DiskWriter

FLATTEN_DEPTH = Options().event_flatten_level - 1


@pytest.fixture(autouse=True)
def jax_python_lane(monkeypatch):
    """The JAX package ingests through its Python lane (see the module
    docstring)."""
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    monkeypatch.setattr(jax_native, "flatten_columnar", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "flatten_ndjson", lambda *a, **k: None)


def port_at(tmp_path, tag: str) -> Parseable:
    opts = Options()
    opts.local_staging_path = tmp_path / f"staging-{tag}"
    return Parseable(opts, StorageOptions(root=tmp_path / f"data-{tag}"))


def jax_at(tmp_path, tag: str) -> JaxParseable:
    opts = JaxOptions()
    opts.local_staging_path = tmp_path / f"jax-staging-{tag}"
    return JaxParseable(opts, JaxStorageOptions(backend="local-store", root=tmp_path / f"jax-data-{tag}"))


def staged(p, stream: str) -> pa.Table | None:
    batches = p.streams.get(stream).staging_batches()
    if not batches:
        return None
    return pa.Table.from_batches(batches).drop_columns(["p_timestamp"])


def same_rows(t: pa.Table, want: pa.Table) -> bool:
    """Equal tables, or the same rows in another order: files of different
    schemas stage under keys the two packages hash differently, so their
    file order may differ. Floats print exactly (repr)."""
    if t.equals(want):
        return True

    def rows(x: pa.Table) -> list[str]:
        return sorted(json.dumps(r, sort_keys=True, default=repr) for r in x.to_pylist())

    return rows(t) == rows(want)


def lane_moves(before: dict, after: dict) -> list[tuple[str, str, int]]:
    return [
        (lane, r, after[lane][r] - before[lane][r])
        for lane in after for r in after[lane] if after[lane][r] != before[lane][r]
    ]


class Lanes:
    """One port Parseable per way in (default ladder, NDJSON forced, Python
    lane) and one JAX Parseable; `run` ingests a body through all four."""

    KINDS = ("native", "ndjson", "python", "jax")

    def __init__(self, tmp_path):
        self.ps = {k: port_at(tmp_path, k) for k in self.KINDS[:3]}
        self.ps["jax"] = jax_at(tmp_path, "jax")

    def close(self) -> None:
        for p in self.ps.values():
            p.shutdown()

    def run(self, stream: str, body: bytes, monkeypatch, shards: int | None = None):
        """Ingest `body` every way; returns (count, table, lane the default
        ladder took) after checking they all agree."""
        outcomes = {}
        lane = None
        for kind, p in self.ps.items():
            p.create_stream_if_not_exists(stream)
            with monkeypatch.context() as m:
                if shards is not None:
                    m.setattr(native, "SHARD_MIN_BYTES", 0)
                    m.setattr(native, "PARSE_SHARDS", shards)
                if kind == "ndjson":
                    m.setattr(native, "flatten_columnar", lambda *a, **k: None)
                before = IU.lane_stats()
                try:
                    if kind == "jax":
                        count = jax_ingest(p, stream, None, JaxLogSource.JSON, {}, raw_body=body)
                    elif kind == "python":
                        count = IU.flatten_and_push_logs(p, stream, json.loads(body), LogSource.JSON, {})
                    else:
                        count = IU.flatten_and_push_logs(p, stream, None, LogSource.JSON, {}, raw_body=body)
                    outcomes[kind] = ("ok", count)
                except (IU.IngestError, JaxIngestError):
                    outcomes[kind] = ("err", None)
                if kind != "jax":
                    moved = lane_moves(before, IU.lane_stats())
                    assert len(moved) == 1 and moved[0][2] == 1, (kind, moved)
                    if kind == "native":
                        lane = moved[0][:2]
                    elif kind == "python":
                        assert moved[0][:2] == ("python", "hit"), moved
                    else:
                        assert moved[0][:2] != ("columnar", "hit"), moved
        assert len(set(outcomes.values())) == 1, f"lanes disagree: {outcomes}"
        status, count = outcomes["jax"]
        if status == "err":
            return None, None, lane
        tables = {k: staged(p, stream) for k, p in self.ps.items()}
        want = tables["jax"]
        for kind, t in tables.items():
            if want is None:
                assert t is None, f"{kind} staged rows where the JAX package staged none"
                continue
            assert t is not None, f"{kind} staged nothing"
            assert t.schema.equals(want.schema), f"{kind} schema:\n{t.schema}\nvs JAX\n{want.schema}"
            assert same_rows(t, want), f"{kind} values drift from the JAX package"
        return count, want, lane


@pytest.fixture
def lanes(tmp_path):
    ls = Lanes(tmp_path)
    yield ls
    ls.close()


# ------------------------------------------------------------ the library


def test_library_builds_into_build_native_and_loads():
    lib = native.load()
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "native")
    assert path.is_file() and path.name.startswith("libptpu_torch_fastpath_")
    assert lib.ptpu_cols_live() >= 0


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """`false` as the compiler: the target probe fails, and with the probe
    bypassed the compile itself fails; a missing compiler raises too. Each
    is a NativeError, and nothing is left in the build directory."""
    monkeypatch.setattr(native, "COMPILER", "false")
    with pytest.raises(native.NativeError):
        native.build(tmp_path)
    monkeypatch.setattr(native, "_target_tag", lambda cxx: "")
    with pytest.raises(native.NativeError, match="failed on fastpath.cpp"):
        native.build(tmp_path)
    assert not list(tmp_path.glob("*.so*"))
    monkeypatch.setattr(native, "COMPILER", "no-such-compiler-for-the-port")
    with pytest.raises(native.NativeError, match="not found"):
        native.build(tmp_path)


def test_no_silent_fallback_when_the_library_cannot_build(tmp_path, monkeypatch):
    """A raw body with no library to parse it raises; it never drops to the
    Python lane."""
    gc.collect()  # results freed with the library unbound would leak
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "COMPILER", "false")
    p = port_at(tmp_path, "nolib")
    try:
        p.create_stream_if_not_exists("s")
        before = IU.lane_stats()
        with pytest.raises(native.NativeError):
            IU.flatten_and_push_logs(p, "s", None, LogSource.JSON, {}, raw_body=b'[{"a": 1}]')
        assert IU.lane_stats() == before
        assert staged(p, "s") is None
    finally:
        p.shutdown()


def test_a_missing_export_raises():
    """A library without one of the exports is refused, not half-bound."""
    partial = SimpleNamespace(ptpu_flatten_ndjson=SimpleNamespace(), ptpu_free=SimpleNamespace())
    with pytest.raises(native.NativeError, match="lacks the export ptpu_flatten_columnar"):
        native._bind(partial)


# ------------------------------------------- the JAX package's cases


CASES = {
    "flat_records": [
        {"host": f"h{i}", "status": 200 + i, "ok": i % 2 == 0, "msg": None} for i in range(50)
    ],
    "nested_objects": [{"a": {"b": {"c": i}, "d": "x"}, "e": float(i) / 3} for i in range(20)],
    "unicode_and_escapes": [{"msg": 'quote " backslash \\ newline \n tab \t é 漢字 ', "k": 1}],
    "escaped_keys": [{"a\nb": 1, "nested": {'we"ird': 2}}],
    "timestampy_strings": [{"timestamp": f"2024-05-01T10:00:{i:02d}Z", "v": i} for i in range(30)],
    "non_timestampy_iso_string": [{"note": "2024-05-01T10:00:00Z", "v": 1}],
    "numbers_to_float64": [{"n": 1}, {"n": 2.5}, {"n": -3}],
    "single_object": {"a": 1, "b": {"c": "x"}},
    "fallback_array_of_objects": {"tags": [{"k": "a"}, {"k": "b"}], "host": "x"},
    "fallback_sparse_keys": [{"a": 1}, {"a": 2, "b": 3}],
    "fallback_scalar_array": [{"vals": [1, 2, 3], "k": "scalar-array"}],
    "fallback_deep": [{"deep": {"x": {"y": {"z": {"w": {"q": 1}}}}}}],
    # a string column under a time-ish name ("at" in path, status, latency)
    # none of whose values parse: string, on the columnar tier
    "access_log": [
        {"host": f"10.0.0.{i % 4}", "method": "GET", "path": f"/api/v1/resource{i % 7}",
         "message": "request completed in 25ms", "status": 200 + 100 * (i % 4),
         "bytes": 1000 + i, "latency_ms": i * 0.37}
        for i in range(40)
    ],
    # some values of a time-ish column parse, some do not: the Python lane
    # types it timestamp and nulls the rest
    "timeish_partly_parses": [{"created_at": "2024-05-01T10:00:00Z"}, {"created_at": "soon"}],
}
CASE_LANES = {
    "timeish_partly_parses": ("python", "declined"),
    "escaped_keys": ("ndjson", "hit"),
    "fallback_array_of_objects": ("python", "declined"),
    "fallback_sparse_keys": ("python", "declined"),
    "fallback_scalar_array": ("python", "declined"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_case_stages_what_the_jax_package_stages(case, lanes, monkeypatch):
    body = json.dumps(CASES[case]).encode()
    count, table, lane = lanes.run("s", body, monkeypatch)
    assert count == table.num_rows > 0
    assert lane == CASE_LANES.get(case, ("columnar", "hit")), lane
    if case == "non_timestampy_iso_string":
        assert pa.types.is_string(table.schema.field("note").type)
    if case == "timestampy_strings":
        assert pa.types.is_timestamp(table.schema.field("timestamp").type)


def test_malformed_json_raises_ingest_error(tmp_path):
    p = port_at(tmp_path, "bad")
    try:
        p.create_stream_if_not_exists("s")
        before = IU.lane_stats()
        with pytest.raises(IU.IngestError, match="invalid JSON"):
            IU.flatten_and_push_logs(p, "s", None, LogSource.JSON, {}, raw_body=b'{"a": ')
        assert lane_moves(before, IU.lane_stats()) == [("python", "declined", 1)]
    finally:
        p.shutdown()


def test_schema_evolution_across_lanes(lanes, monkeypatch):
    """A second batch adding a field widens the stream schema as the JAX
    package's does, whichever tier each batch took."""
    took = []
    for body in (b'[{"a": 1.5}]', b'[{"a": 2.5, "b": "x"}]', b'[{"a": [1], "b": "y"}]',
                 b'[{"b": "z", "c": true}]', b'[{"ended": "2024-05-01T10:00:00Z"}]',
                 b'[{"ended": "never"}]', b'[{"ended": "2024-05-02T10:00:00.5Z"}]'):
        took.append(lanes.run("evo", body, monkeypatch)[2])
    t = staged(lanes.ps["native"], "evo")
    assert {"a", "b", "c", "ended", "ended_str"} <= set(t.schema.names) and t.num_rows == 7
    # a value that does not parse under a stored timestamp column is renamed
    # per record, by the Python lane
    assert took[5] == ("python", "declined") and took[6] == ("columnar", "hit")


def test_native_depth_matches_the_python_depth_guard():
    """C++ depth N == Python level N+1: both native tiers reject exactly
    where the JAX package's depth guard does."""
    for levels in range(1, 6):
        rec: dict = {"leaf": 1}
        for i in range(levels - 1):
            rec = {f"l{i}": rec}
        body = json.dumps([rec]).encode()
        for max_level in range(1, 8):
            deep = jax_too_deep([rec], max_level)
            assert (native.flatten_ndjson(body, max_level - 1) is None) == deep, (levels, max_level)
            assert (native.flatten_columnar(body, max_level - 1) is None) == deep, (levels, max_level)
    gc.collect()
    assert native.columnar_live() == 0


def test_columnar_buffers_are_freed_with_the_last_array():
    gc.collect()
    base = native.columnar_live()
    r = native.flatten_columnar(b'[{"a": 1.5, "s": "xyz"}, {"a": null, "s": "w"}]', 9)
    names, arrays, nrows = r
    assert nrows == 2 and native.columnar_live() == base + 1
    keep = arrays[names.index("s")]
    del r, names, arrays
    gc.collect()
    assert native.columnar_live() == base + 1, "buffers freed while still referenced"
    assert keep.to_pylist() == ["xyz", "w"]
    del keep
    gc.collect()
    assert native.columnar_live() == base == 0


# --------------------------------------------------- staging writes


def direct_counts(p, stream: str) -> tuple[int, int, int]:
    ws = p.streams.get(stream).writer.disk.values()
    return (
        sum(w.direct_writes for w in ws),
        sum(w.buffered_writes for w in ws),
        sum(w.adapted_writes for w in ws),
    )


def test_a_columnar_hit_is_written_direct(tmp_path):
    p = port_at(tmp_path, "direct")
    try:
        p.create_stream_if_not_exists("s")
        body = json.dumps([{"host": f"h{i}", "v": float(i)} for i in range(100)]).encode()
        before = IU.lane_stats()
        assert IU.flatten_and_push_logs(p, "s", None, LogSource.JSON, {}, raw_body=body) == 100
        assert lane_moves(before, IU.lane_stats()) == [("columnar", "hit", 1)]
        assert direct_counts(p, "s") == (1, 0, 0)
        # the Python lane's batch of the same shape is regrouped
        IU.flatten_and_push_logs(p, "s", json.loads(body), LogSource.JSON, {})
        assert direct_counts(p, "s") == (1, 1, 0)
        assert staged(p, "s").num_rows == 200
    finally:
        p.shutdown()
    gc.collect()
    assert native.columnar_live() == 0


def test_direct_write_keeps_ingestion_order_and_adapted_batches_regroup(tmp_path):
    schema = pa.schema([("a", pa.float64()), ("b", pa.string())])
    w = DiskWriter(tmp_path / "x.part.arrows", schema, batch_rows=1000)
    w.write(pa.record_batch([pa.array([1.0]), pa.array(["p"])], schema=schema))
    w.write(pa.record_batch([pa.array([2.0]), pa.array(["d"])], schema=schema), direct=True)
    narrow = pa.schema([("a", pa.float64())])
    w.write(pa.record_batch([pa.array([3.0])], schema=narrow), direct=True)
    # the adapted batch is regrouped like any buffered one
    assert (w.direct_writes, w.buffered_writes, w.adapted_writes) == (1, 2, 1)
    final = w.finish()
    t = ipc.open_file(pa.memory_map(str(final))).read_all()
    assert t.column("a").to_pylist() == [1.0, 2.0, 3.0]
    assert t.column("b").to_pylist() == ["p", "d", None]


# ------------------------------------------------------------- the fuzz

STRINGS = [
    "plain",
    "uni é 漢字",
    'q"uote',
    "back\\slash",
    "nl\nnl",
    "tab\twhee",
    "",
    "2024-05-01T10:00:00Z",
    "2024-05-01T10:00:00.123456Z",
    "not a time",
    "🚀 emoji",
    "é́ combining",
]


def gen_scalar(rng: random.Random):
    roll = rng.random()
    if roll < 0.2:
        return rng.randrange(-(10**12), 10**12)
    if roll < 0.4:
        return rng.uniform(-1e6, 1e6)
    if roll < 0.5:
        return bool(rng.getrandbits(1))
    if roll < 0.6:
        return None
    return rng.choice(STRINGS)


def gen_value(rng: random.Random, depth: int):
    roll = rng.random()
    if depth < 4 and roll < 0.15:
        return {f"n{j}": gen_value(rng, depth + 1) for j in range(rng.randrange(1, 3))}
    if roll < 0.22:
        return [gen_scalar(rng) for _ in range(rng.randrange(0, 3))]
    return gen_scalar(rng)


def gen_payload(rng: random.Random):
    """Nested dicts, nulls, unicode keys and values, escapes, mixed types,
    arrays, deep nesting, sparse keys, timestampy strings, empty batches."""
    nrec = rng.randrange(0, 7)
    ncol = rng.randrange(1, 6)
    names = []
    makers = []
    for i in range(ncol):
        suffix = rng.choice(["k", "time", "é key", "created_at", "x"])
        names.append(f"c{i}_{suffix}")
        if rng.random() < 0.75:
            # column-typed: uniform batches that should hit the fast tiers
            proto = gen_scalar(rng)

            def maker(rng, proto=proto):
                if isinstance(proto, bool):
                    return bool(rng.getrandbits(1))
                if isinstance(proto, int):
                    return rng.randrange(-(10**9), 10**9)
                if isinstance(proto, float):
                    return rng.uniform(-1e9, 1e9)
                if isinstance(proto, str):
                    return rng.choice(STRINGS)
                return None

        else:

            def maker(rng):
                return gen_value(rng, 1)

        makers.append(maker)
    recs = []
    for _ in range(nrec):
        rec = {name: maker(rng) for name, maker in zip(names, makers)}
        if rec and rng.random() < 0.08:
            rec.pop(rng.choice(list(rec)))  # sparse keys -> Python tier
        recs.append(rec)
    if nrec == 1 and rng.random() < 0.3:
        return recs[0]  # single-object payload
    return recs


def native_table(body: bytes, shards: int) -> pa.Table | None:
    r = native.flatten_columnar(body, FLATTEN_DEPTH, shards=shards)
    if r is None:
        return None
    names, arrays, nrows = r
    if not names:
        return pa.table({"_rows": pa.array([nrows])})
    return pa.Table.from_arrays(arrays, names=names)


def ipc_bytes(t: pa.Table) -> bytes:
    sink = io.BytesIO()
    with ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return sink.getvalue()


def assert_shard_invariant(body: bytes, counts=(1, 2, 3, 16)) -> pa.Table | None:
    """Every shard count gives the same decline, or the same table byte for
    byte in Arrow IPC, as one shard."""
    base = native_table(body, counts[0])
    want = None if base is None else ipc_bytes(base)
    for s in counts[1:]:
        t = native_table(body, s)
        assert (t is None) == (base is None), f"shards={s} and shards={counts[0]} disagree on the decline"
        if t is not None:
            assert t.schema.equals(base.schema) and t.equals(base), f"shards={s} drift"
            assert ipc_bytes(t) == want, f"shards={s} differs in its bytes"
    return base


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_three_tiers_stage_what_the_jax_package_stages(seed, lanes, monkeypatch):
    rng = random.Random(0xC0FFEE + seed)
    seen = set()
    for i in range(12):
        body = json.dumps(gen_payload(rng)).encode()
        _count, _table, lane = lanes.run(f"s{i}", body, monkeypatch, shards=(1, 2, 4)[i % 3])
        seen.add(lane)
        assert_shard_invariant(body)
    assert ("columnar", "hit") in seen
    gc.collect()
    assert native.columnar_live() == 0


def test_fuzz_schema_evolution_across_tiers(lanes, monkeypatch):
    """Consecutive batches into one stream, each through every way in:
    widening and stored-schema overrides agree whatever tier each took."""
    rng = random.Random(42)
    for i in range(6):
        for _batch in range(3):
            lanes.run(f"evo{i}", json.dumps(gen_payload(rng)).encode(), monkeypatch)
    gc.collect()
    assert native.columnar_live() == 0


def deep_record() -> dict:
    deep: dict = {"leaf": 1}
    for j in range(12):
        deep = {f"l{j}": deep}
    return deep


DECLINES = [
    ([{"a": 1.5, "b": "x"}, {"a": 2.0, "b": "y"}], ("columnar", "hit")),
    ([{"a\nb": 1}], ("ndjson", "hit")),  # escaped key: the columnar tier declines
    ([{"a": [1, 2]}], ("python", "declined")),  # array semantics
    ([{"a": 1}, {"b": 2}], ("python", "declined")),  # sparse keys
    ([{"a": 1}, {"a": "x"}], ("python", "declined")),  # mixed-type column
    ([deep_record()], ("python", "declined")),  # past the depth limit: every tier declines, Python raises
]


@pytest.mark.parametrize("payload,lane", DECLINES, ids=[
    "clean", "escaped_key", "array", "sparse_keys", "mixed_types", "too_deep",
])
def test_declines_land_on_the_expected_tier(payload, lane, lanes, monkeypatch):
    _count, _table, took = lanes.run("d", json.dumps(payload).encode(), monkeypatch)
    assert took == lane
    gc.collect()
    assert native.columnar_live() == 0


# ------------------------------------------------- shard boundaries


def test_shard_boundary_record_straddle():
    """One record dwarfing the rest: interior byte targets land inside it."""
    recs = [{"m": "x" * 5000, "v": 1.0}] + [{"m": f"r{i}", "v": float(i)} for i in range(50)]
    t = assert_shard_invariant(json.dumps(recs).encode())
    assert t is not None and t.num_rows == 51
    del t
    gc.collect()
    assert native.columnar_live() == 0


def test_shard_boundary_multibyte_utf8():
    """Multi-byte UTF-8 around every plausible split point: pads shift the
    record boundary through all phases of 2/3/4-byte sequences."""
    for ch in ("é", "漢", "🚀"):
        for pad in range(1, 8):
            recs = [{"m": ch * (17 + pad), "k": "a" * pad, "v": float(j)} for j in range(40)]
            t = assert_shard_invariant(json.dumps(recs, ensure_ascii=False).encode())
            assert t is not None and t.num_rows == 40
            assert t.column("m")[0].as_py() == ch * (17 + pad)
            del t
    gc.collect()
    assert native.columnar_live() == 0


def test_shard_boundary_brace_comma_inside_string():
    """Strings holding the record separator '},{"': the optimistic split
    bites, a shard fails mid-record, and the single-shard rerun gives the
    same table."""
    evil = 'x},{"fake": 1, "y": 2}'
    recs = [{"m": evil, "v": float(i)} for i in range(64)]
    t = assert_shard_invariant(json.dumps(recs).encode())
    assert t is not None and t.num_rows == 64 and t.column("m")[63].as_py() == evil
    t2 = assert_shard_invariant(json.dumps(recs, separators=(",", ":")).encode())
    assert t2 is not None and t2.equals(t)
    del t, t2
    gc.collect()
    assert native.columnar_live() == 0


def test_number_parse_is_bit_exact_against_python():
    """The native decimal -> double conversion against Python's float() on
    each tier of its fast path (exact doubles; 80-bit near-halfway bails;
    strtod past 19 digits, huge exponents, subnormals)."""
    adversarial = [
        "0", "-0.0", "0e9", "-0e-999", "0.000000000000000000000000001",
        "437.2579414323392", "0.1", "0.2", "0.3", "2.5e-1",
        "9007199254740992", "9007199254740993",
        "999999999999999999", "9999999999999999999",
        "18446744073709551615", "18446744073709551616",
        "123456789012345678901234567890",
        "1e22", "1e23", "-1e23", "1e27", "1e-27", "1e28", "1e-28",
        "1.7976931348623157e308", "2.2250738585072014e-308",
        "5e-324", "1e-400", "1e400",
        "6.62607015e-34", "6.02214076e23", "3.141592653589793",
    ]
    rng = random.Random(0xD0B1E)
    for _ in range(400):
        adversarial.append(repr(rng.uniform(-1e9, 1e9)))
        adversarial.append(repr(rng.uniform(0, 1)))
        nd = rng.randrange(1, 22)
        ip = str(rng.randrange(0, 10**nd))
        fp = "".join(rng.choice("0123456789") for _ in range(nd))
        adversarial.append(f"{ip}.{fp}e{rng.randrange(-30, 31)}")
    # the numerals verbatim (json.dumps would launder them through repr)
    body = ("[" + ",".join('{"v": %s}' % s for s in adversarial) + "]").encode()
    t = native_table(body, 1)
    assert t is not None, "a numeric payload stays on the columnar tier"
    for s, g in zip(adversarial, t.column("v").to_pylist(), strict=True):
        want = float(s)
        assert (g == want and repr(g) == repr(want)) or (g != g and want != want), (s, g, want)
    del t
    gc.collect()
    assert native.columnar_live() == 0
