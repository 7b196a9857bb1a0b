"""K3, the fold's front half, and the select path, on the CPU.

The port lowers a block's WHERE tree, time bounds, padding mask, GROUP BY
keys and operand rows into one packed program (`ops/fold_cuda.py`), which
the hand kernels K3a (`mask_ids`) and K3b (`stack_operands`) run on the
card and their plain versions interpret here. The same seeded tables go
through
- the plain K3a mask against the JAX `PredicateCompiler.trace`
  (`parseable_tpu/query/executor_tpu.py:314`), row for row, for every
  non-negated filter; negations against both port engines' and pyarrow's
  three-valued logic, and against the JAX CPU engine where it follows it;
- the plain K3b rows against the JAX `_kernel_stacks` (:838) and the
  matrices the JAX `fused_groupby_block` builds from them, bit for bit;
- the time-bin key against the JAX fold's int32 formula (floor division,
  wrapping adds);
- the port's select path ("gpu" on the CPU) against the JAX CPU and "tpu"
  engines, with no block taken off the device path.
Masks and ids are exact: both sides compute them without rounding.
"""

import math
import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import chip_smoke
from parseable_tpu.ops.device import encode_table as jax_encode
from parseable_tpu.query.executor import QueryExecutor as JaxCpuExecutor
from parseable_tpu.query.executor_tpu import PredicateCompiler as JaxCompiler
from parseable_tpu.query.executor_tpu import _kernel_stacks as jax_kernel_stacks
from parseable_tpu.query.planner import plan as jax_plan
from parseable_tpu.query.sql import parse_sql as jax_parse
from parseable_tpu_torch.ops import fold_cuda as F
from parseable_tpu_torch.ops.device import encode_table as port_encode
from parseable_tpu_torch.ops.device import f64_name
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query.executor import QueryExecutor as PortCpuExecutor
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.sql import parse_sql as port_parse
from tests.test_torch_executor import (
    FILTERS,
    NEGATIONS,
    jax_cpu,
    jax_tpu,
    make_table,
    port_cpu,
    port_gpu,
    with_null_hosts,
)

EXTRA_FILTERS = [
    "lat BETWEEN 10 AND 20", "status IN (200.0, 404)", "lat IS NULL", "host IS NULL",
    "message NOT LIKE 'error%'", "regexp_like(message, 'time')", "path < '/p3'", "true",
    "status >= 300 OR host = 'h1' AND lat > 20", "bytes = 26214.0 OR lat <= 0.5",
    "p_timestamp < '2024-05-01T10:00:00.001Z'", "p_timestamp != '2024-05-01T11:00:00Z'",
]
POSITIVE = [f for f in FILTERS + EXTRA_FILTERS if "NOT (" not in f]


@pytest.fixture(scope="module")
def blocks() -> list[pa.Table]:
    """A table of 3,001 rows (padded to 4,096) with 5% NULL hosts and 10%
    NULL lat values, and one of 2,048 rows (no padding) and 40 hosts."""
    return [with_null_hosts(make_table(71, 3001, 5), 72), make_table(73, 2048, 40)]


def where_of(text: str, parse):
    return parse(f"SELECT count(*) FROM t WHERE {text}").where


def port_block(table: pa.Table):
    """Every column of `table` and the f64 copies a WHERE may compare."""
    names = set(table.column_names)
    enc = port_encode(table, names | {f64_name(c) for c in names})
    dev = {}
    for name, col in enc.columns.items():
        dev[name] = torch.from_numpy(col.values)
        dev[f"{name}__valid"] = torch.from_numpy(col.valid)
    if enc.num_rows != enc.block_rows:
        dev["__rowmask"] = torch.from_numpy(enc.row_mask)
    return enc, dev


def run(prog: F.Program, dev: dict, n: int):
    words = torch.from_numpy(prog.pack())
    slots = [(dev[v] if v else None, dev[m] if m else None) for v, m in prog.slots]
    mask, ids = F.mask_ids(words, slots, n)
    return words, slots, mask, ids


def port_mask(text: str, table: pa.Table) -> np.ndarray:
    enc, dev = port_block(table)
    prog = F.Program()
    X.PredicateCompiler().lower(where_of(text, port_parse), enc, prog)
    return run(prog, dev, enc.block_rows)[2].numpy()[: enc.num_rows]


def jax_mask(text: str, table: pa.Table) -> np.ndarray:
    enc = jax_encode(table, None)
    dev = {"__ones": jnp.ones(enc.block_rows, bool)}
    for name, col in enc.columns.items():
        dev[name] = jnp.asarray(col.values)
        dev[f"{name}__valid"] = jnp.asarray(col.valid)
    where = where_of(text, jax_parse)
    comp = JaxCompiler()
    luts = [jnp.asarray(lut) for lut in comp.collect_luts(where, enc)]
    return np.asarray(comp.trace(where, enc, dev, luts))[: enc.num_rows]


@pytest.mark.parametrize("text", POSITIVE)
def test_mask_matches_the_jax_trace(text, blocks):
    for table in blocks:
        got = port_mask(text, table)
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, jax_mask(text, table), err_msg=text)


@pytest.mark.parametrize("name", list(NEGATIONS))
def test_negated_mask_follows_three_valued_logic(name, blocks):
    """A negation over a NULL operand drops the row: the plain mask equals
    the port's CPU engine and pyarrow's Kleene kernels. The JAX CPU engine
    agrees except under NOT IN, where it keeps the NULL-host rows."""
    text, kleene = NEGATIONS[name]
    for table in blocks:
        got = port_mask(text, table)
        oracle = kleene(table).fill_null(False).to_numpy(zero_copy_only=False)
        cpu = PortCpuExecutor(port_plan(port_parse(f"SELECT * FROM t WHERE {text}")))
        port = cpu._where_mask(table).fill_null(False).to_numpy(zero_copy_only=False)
        jexe = JaxCpuExecutor(jax_plan(jax_parse(f"SELECT * FROM t WHERE {text}")))
        jcpu = jexe._where_mask(table).fill_null(False).to_numpy(zero_copy_only=False)
        np.testing.assert_array_equal(got, oracle, err_msg=name)
        np.testing.assert_array_equal(got, port, err_msg=name)
        if "IN" in text:
            null_host = table["host"].is_null().to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(jcpu, got | null_host, err_msg=name)
        else:
            np.testing.assert_array_equal(jcpu, got, err_msg=name)


LAYOUT = dict(
    sum_cols=["bytes"], sq_cols=["lat"], min_cols=["lat"], max_cols=["bytes", "status"],
    pct_cols=["lat"], cnt_cols=["lat", "host"],
)


def test_operand_rows_match_the_jax_stacks(blocks):
    """K3b's rows are the matrices that the JAX `_kernel_stacks` and
    `fused_groupby_block` build, with the WHERE, a time bound and the
    padding mask folded into the mask; one lat value is NaN, so the
    percentile rows' NaN-aware validity shows."""
    table = blocks[0]
    lat = table["lat"].to_pylist()
    lat[next(i for i, v in enumerate(lat) if v is not None)] = float("nan")
    table = table.set_column(table.schema.get_field_index("lat"), "lat", pa.array(lat))
    text = "status >= 300 AND message LIKE '%error%'"
    lo = "2024-05-01T10:20:00Z"
    sql = f"SELECT host, count(*) FROM t WHERE {text} AND p_timestamp >= '{lo}' GROUP BY host"
    ex = X.GpuQueryExecutor(port_plan(port_parse(sql)), device="cpu")
    enc, dev = port_block(table)
    layout = X.PlanLayout(key_specs=[], distinct_cols=["host"], **LAYOUT)
    prog = F.Program()
    X.PredicateCompiler().lower(where_of(text, port_parse), enc, prog)
    ex._finish_program(prog, enc, [], [], layout, (X.time_ticks(X.parse_rfc3339(lo), "ms", ">="), None))
    words, slots, mask, _ = run(prog, dev, enc.block_rows)
    frows, brows = F.stack_operands(words, slots, mask, prog.n_frows, prog.n_brows)

    jenc = jax_encode(table, None)
    jdev = {n: jnp.asarray(c.values) for n, c in jenc.columns.items()}
    jdev.update({f"{n}__valid": jnp.asarray(c.valid) for n, c in jenc.columns.items()})
    sum_v, min_v, max_v, valid_v, n_sumk, n_mink, n_maxk = (
        np.asarray(x) if not isinstance(x, int) else x
        for x in jax_kernel_stacks(jdev, SimpleNamespace(**LAYOUT), jenc.block_rows)
    )
    m = jax_mask(f"{text} AND p_timestamp >= '{lo}'", table)
    m = np.concatenate([m, np.zeros(jenc.block_rows - jenc.num_rows, bool)])
    np.testing.assert_array_equal(mask.numpy(), m)
    vmask = valid_v & m[None, :]
    a_rows = np.concatenate([m[None].astype(np.float32), vmask.astype(np.float32),
                             np.where(vmask[:n_sumk], sum_v, np.float32(0))])
    o = X.OperandRows.of(layout)
    assert (o.n_sumk, o.n_mink, o.n_maxk, o.n_a) == (n_sumk, n_mink, n_maxk, len(a_rows))
    np.testing.assert_array_equal(frows[: o.n_a].numpy(), a_rows)
    np.testing.assert_array_equal(frows[o.n_a :].numpy(), np.concatenate([min_v, max_v]))
    b_valid = vmask[n_sumk : n_sumk + n_mink + n_maxk]
    k7_valid = vmask[len(LAYOUT["sum_cols"]) : n_sumk]
    k5_live = m & jenc.columns["host"].valid
    np.testing.assert_array_equal(brows.numpy(), np.concatenate([b_valid, k7_valid, k5_live[None]]))
    assert np.isnan(frows[o.n_a + o.n_min].numpy()).sum() == 1  # the percentile value row
    assert not brows[o.n_min].numpy()[np.isnan(frows[o.n_a + o.n_min].numpy())].any()


def jax_time_bins(ts: np.ndarray, shift: int, bin_ms: int, k_off: int, cap: int) -> np.ndarray:
    """The JAX fold's time-bin key (executor_tpu.py:2894-2899), in jnp int32."""
    t = jnp.asarray(ts, jnp.int32)
    return np.asarray(jnp.clip((t + shift) // jnp.int32(bin_ms) + k_off, 0, cap - 1))


@pytest.mark.parametrize("shift,bin_ms,k_off", [(0, 60_000, -3), (17, 7_000, 5), (2**30 - 1, 3, -7)])
def test_time_bin_key_floors_and_wraps_as_jax(shift, bin_ms, k_off):
    """Negative times, a floor division below zero and an int32 add that
    wraps: the plain KEY_TIME gives what the JAX fold's int32 jnp gives;
    a dictionary key clamps its remap from above only."""
    rng = np.random.default_rng(5)
    ts = rng.integers(-(2**31), 2**31, 5000, dtype=np.int64).astype(np.int32)
    ts[:4] = [2**31 - 1, -(2**31), -1, 0]
    codes = rng.integers(-128, 128, 5000).astype(np.int8)
    remap = rng.integers(0, 40, 256).astype(np.int32)
    remap[7] = 2**30
    prog = F.Program()
    prog.const(True)
    prog.key_time(prog.slot("ts", None), shift, bin_ms, k_off, 16, 1)
    prog.key_dict(prog.slot("codes", None), remap, 32, 16)
    dev = {"ts": torch.from_numpy(ts), "codes": torch.from_numpy(codes)}
    _, _, mask, ids = run(prog, dev, 5000)
    want = jax_time_bins(ts, shift, bin_ms, k_off, 16) + 16 * np.minimum(
        remap[codes.astype(np.int64) & 255], 31
    )
    assert mask.all()
    np.testing.assert_array_equal(ids.numpy(), want)


def jax_local_ids(keys: list[tuple[np.ndarray, int]]) -> np.ndarray:
    """The JAX local fold's own-code ids (executor_tpu.py:2493-2500), in jnp:
    sum of min(code, cap - 1) * stride, first key minor."""
    ids, stride = None, 1
    for codes, cap in keys:
        part = jnp.minimum(jnp.asarray(codes), cap - 1) * jnp.int32(stride)
        ids = part if ids is None else ids + part
        stride *= cap
    return np.asarray(ids.astype(jnp.int32))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_key_code_matches_the_jax_local_fold(dtype):
    """KEY_CODE (the block-local fold's keys): a block's own codes of every
    width, clamped from above at cap - 1 (codes past it, the null slot and
    padding among them), in mixed radix with a time-bin key and a second
    code key; and a pair key alone, as pair mode folds it."""
    rng = np.random.default_rng(6)
    n = 5000
    top = np.iinfo(dtype).max
    cap = min(128, top + 1)
    codes = rng.integers(0, top + 1, n).astype(dtype)
    other = rng.integers(0, 40, n).astype(np.int16)
    ts = rng.integers(0, 600_000, n).astype(np.int32)
    prog = F.Program()
    prog.const(True)
    prog.key_code(prog.slot("codes", None), cap, 1)
    prog.key_time(prog.slot("ts", None), 0, 60_000, 0, 16, cap)
    prog.key_code(prog.slot("other", None), 32, cap * 16)
    dev = {"codes": torch.from_numpy(codes), "ts": torch.from_numpy(ts),
           "other": torch.from_numpy(other)}
    _, _, _, ids = run(prog, dev, n)
    want = jax_local_ids([(codes, cap)]) + cap * jax_time_bins(ts, 0, 60_000, 0, 16) + \
        cap * 16 * jax_local_ids([(other, 32)])
    np.testing.assert_array_equal(ids.numpy(), want)
    pairs = rng.integers(0, 1 << 16, n).astype(np.int32)
    prog = F.Program()
    prog.const(True)
    prog.key_code(prog.slot("__pairkey", None), 1 << 15, 1)
    _, _, _, ids = run(prog, {"__pairkey": torch.from_numpy(pairs)}, n)
    np.testing.assert_array_equal(ids.numpy(), jax_local_ids([(pairs, 1 << 15)]))


@pytest.mark.parametrize(
    "text",
    ["lower(host) = 'h0'", "bytes + 1 > 5", "lat IN ('x', 'y')", "p_timestamp IN ('a')", "1"],
)
def test_lowering_refuses_what_the_program_cannot_express(text, blocks):
    enc, _ = port_block(blocks[0])
    with pytest.raises(X.UnsupportedOnDevice):
        X.PredicateCompiler().lower(where_of(text, port_parse), enc, F.Program())


@pytest.mark.parametrize("leaves,ok", [(F.MAX_STACK, True), (F.MAX_STACK + 1, False)])
def test_lowering_refuses_a_program_deeper_than_the_stack(leaves, ok, blocks):
    """A right-nested chain of n ANDs keeps n verdicts on the stack at once."""
    text = f"status = {leaves}"
    for i in range(leaves - 1, 0, -1):
        text = f"status = {i} AND ({text})"
    enc, dev = port_block(blocks[1])
    prog = F.Program()
    if ok:
        X.PredicateCompiler().lower(where_of(text, port_parse), enc, prog)
        assert not run(prog, dev, enc.block_rows)[2].any()
    else:
        with pytest.raises(X.UnsupportedOnDevice, match="deeper"):
            X.PredicateCompiler().lower(where_of(text, port_parse), enc, prog)


def test_lowering_refuses_a_program_longer_than_the_kernel_holds(blocks):
    text = " OR ".join(f"status = {i}" for i in range(F.MAX_INSTR // 2 + 1))
    enc, _ = port_block(blocks[1])
    with pytest.raises(X.UnsupportedOnDevice, match="longer"):
        X.PredicateCompiler().lower(where_of(text, port_parse), enc, F.Program())


def test_a_kernel_fault_is_not_a_cpu_fallback(monkeypatch, blocks):
    """A K3 launch that fails raises out of the query, aggregate or select:
    it is never counted as a block for the host."""

    def broken(*args, **kwargs):
        raise F.KernelError("mask_ids: CUDA error 700")

    monkeypatch.setattr(F, "mask_ids", broken)
    for sql in ("SELECT host, count(*) AS c FROM t WHERE status >= 400 GROUP BY host",
                "SELECT host, path FROM t WHERE status >= 400"):
        with pytest.raises(F.KernelError):
            port_gpu(sql, blocks)


# ------------------------------------------------------------ select fuzz


PROJECTIONS = ["host, path, status", "p_timestamp, message, lat", "*", "bytes AS b, lat"]
TAILS = ["", " ORDER BY p_timestamp DESC, bytes LIMIT 25",
         " ORDER BY bytes, p_timestamp LIMIT 10 OFFSET 3", " LIMIT 40"]
SELECT_TRIALS = 30


def same_rows(ref: list[dict], got: list[dict], what: str, ordered: bool) -> None:
    def key(r):
        return tuple((k, repr(v)) for k, v in sorted(r.items()))

    if not ordered:
        ref, got = sorted(ref, key=key), sorted(got, key=key)
    assert [key(r) for r in got] == [key(r) for r in ref], what


def test_select_fuzz_matches_jax_engines():
    """Port select path on the CPU vs the JAX CPU and "tpu" engines,
    seed-pinned: filters x projections x ORDER BY / OFFSET / LIMIT. Every
    block's WHERE runs through K3a (no fallback)."""
    rng = random.Random(4321)
    for trial in range(SELECT_TRIALS):
        tables = [
            make_table(rng.randrange(1 << 30), rng.choice([500, 1500]), rng.choice([2, 5, 40]))
            for _ in range(rng.randint(1, 3))
        ]
        sql = (f"SELECT {rng.choice(PROJECTIONS)} FROM t WHERE {rng.choice(FILTERS)}"
               f"{rng.choice(TAILS)}")
        got, routes = port_gpu(sql, tables)
        # a LIMIT without ORDER BY stops the scan once it holds enough rows
        scanned = len(tables) if "ORDER BY" in sql or "LIMIT" not in sql else routes["device_cold"]
        assert routes["cpu_fallback"] == 0 and routes["device_cold"] == scanned >= 1, (sql, routes)
        assert routes["d2h_bytes"] > 0, routes
        ordered = "ORDER BY" in sql
        what = f"[trial {trial}] {sql}"
        same_rows(jax_cpu(sql, tables), got, what, ordered)
        same_rows(jax_tpu(sql, tables), got, what, ordered)
        same_rows(port_cpu(sql, tables), got, what, ordered)


def test_select_without_where_never_touches_the_device(blocks):
    got, routes = port_gpu("SELECT host, lat FROM t LIMIT 7", blocks)
    assert len(got) == 7
    assert routes["device_cold"] == routes["device_warm"] == routes["h2d_bytes"] == 0, routes
    assert routes["cpu_fallback"] == 0, routes


def test_select_ships_only_the_predicate_columns(blocks):
    """The mask needs host and the timestamp; the projection's path, message
    and bytes are read on the host only."""
    sql = "SELECT path, message, bytes FROM t WHERE host = 'h1'"
    got, routes = port_gpu(sql, blocks)
    hosts = sum(pc.sum(pc.equal(t["host"], "h1")).as_py() for t in blocks)
    assert len(got) == hosts and routes["cpu_fallback"] == 0
    block_bytes = routes["h2d_bytes"] - routes["h2d_aux_bytes"]
    # host codes (1 B) and p_timestamp (4 B); the padded first table also
    # ships their validity (1 B each) and its padding mask (1 B)
    assert block_bytes == 4096 * (1 + 4 + 1 + 1 + 1) + 2048 * (1 + 4), routes


# ------------------------------------------- f64 compares, NULL literals


def f64_columns(n: int = 4096, seed: int = 11):
    """An f64 column with chip_smoke's F64_HAZARDS (values next to the
    literals below, 2^24 + 1, 1e-46, NaN, -0.0), its f32 rounding, and a
    validity with 10% NULLs."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n) * 300
    hazard = rng.random(n) < 0.5
    d[hazard] = rng.choice(np.array(chip_smoke.F64_HAZARDS), int(hazard.sum()))
    return d, d.astype(np.float32), rng.random(n) < 0.9


def plain_mask(build, cols: dict) -> np.ndarray:
    """The plain K3a verdict of the program `build(prog, slots)` over
    `cols` (name -> (values, valid))."""
    prog = F.Program()
    slots = {c: prog.slot(c, f"{c}__valid") for c in cols}
    build(prog, slots)
    dev = {}
    for c, (v, m) in cols.items():
        dev[c], dev[f"{c}__valid"] = torch.from_numpy(v), torch.from_numpy(m)
    n = len(next(iter(cols.values()))[0])
    return run(prog, dev, n)[2].numpy()


NP_CMP = {"=": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
          ">": np.greater, ">=": np.greater_equal}


@pytest.mark.parametrize("literal", [250.0, 250.00000001, 2.0**24 + 1, 1e-46, -0.0, math.nan])
@pytest.mark.parametrize("op", list(F.CMP))
def test_cmp_f64_matches_numpy(op, literal):
    """CMP_F64 compares f64 values, and f32 values read as f64, with the
    exact f64 literal (NaN != t true, every ordered compare false); a
    NULL value is unknown and drops the row."""
    d, f, valid = f64_columns()
    cols = {"d": (d, valid), "f": (f, valid)}
    got = plain_mask(lambda p, s: (p.cmp_f64(s["d"], op, literal), p.cmp_f64(s["f"], op, literal),
                                   p.or_()), cols)
    with np.errstate(invalid="ignore"):
        want = (NP_CMP[op](d, literal) | NP_CMP[op](f.astype(np.float64), literal)) & valid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("negated", [False, True])
@pytest.mark.parametrize("column", ["d", "f"])
def test_in_f64_matches_numpy(column, negated):
    d, f, valid = f64_columns()
    items = [250.0, 12.3, 2.0**24 + 1, 1e-46, math.nan, -0.0]
    x = d if column == "d" else f
    got = plain_mask(lambda p, s: p.in_f64(s[column], items, negated), {column: (x, valid)})
    hit = np.isin(x.astype(np.float64), np.array(items))
    np.testing.assert_array_equal(got, (~hit if negated else hit) & valid)


# (program over one NULL literal and the constants, SQL's answer a row)
NULL_CONSTS = {
    "null": (lambda p: p.const(True, known=False), False),
    "not-null": (lambda p: (p.const(False, known=False), p.not_()), False),
    "null-or-true": (lambda p: (p.const(True, known=False), p.const(True), p.or_()), True),
    "null-or-false": (lambda p: (p.const(True, known=False), p.const(False), p.or_()), False),
    "null-and-false-negated": (
        lambda p: (p.const(True, known=False), p.const(False), p.and_(), p.not_()), True),
    "null-and-true-negated": (
        lambda p: (p.const(True, known=False), p.const(True), p.and_(), p.not_()), False),
}


@pytest.mark.parametrize("name", list(NULL_CONSTS))
def test_const_with_known_zero_is_sql_null(name):
    build, want = NULL_CONSTS[name]
    d, _, valid = f64_columns(64)
    got = plain_mask(lambda p, s: build(p), {"d": (d, valid)})
    np.testing.assert_array_equal(got, np.full(64, want))


def test_lowering_reads_f64_only_where_f32_is_not_exact():
    """status (exact in f32) compares in f32 with 404 and as f64 with
    16777217; lat (not exact) through its f64 copy, which a block encoded
    without it does not have: that block declines."""
    rng = np.random.default_rng(2)
    t = pa.table({"status": pa.array(rng.choice([200.0, 404.0], 100)),
                  "lat": pa.array(rng.random(100) * 500)})
    needed = {"status", "lat", "status#f64", "lat#f64"}
    enc = port_encode(t, needed)
    assert enc.exact_cols == {"status"} and set(enc.columns) == needed - {"status#f64"}

    def ops(text, e=enc):
        prog = F.Program()
        X.PredicateCompiler().lower(where_of(text, port_parse), e, prog)
        ins = F.decode(torch.from_numpy(prog.pack()))[0]
        return [(i[0], prog.slots[i[1]][0]) for i in ins
                if i[0] in (F.CMP_F32, F.CMP_F64, F.IN_F32, F.IN_F64)]

    assert ops("status = 404") == [(F.CMP_F32, "status")]
    assert ops("status < 16777217") == [(F.CMP_F64, "status")]
    assert ops("lat > 250 AND status IN (200, 404)") == [(F.CMP_F64, "lat#f64"), (F.IN_F32, "status")]
    assert ops("lat IN (1, 2)") == [(F.IN_F64, "lat#f64")]
    with pytest.raises(X.UnsupportedOnDevice, match="f64 copy"):
        ops("lat > 250", port_encode(t, {"status", "lat"}))
