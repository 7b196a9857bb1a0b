#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 42]

Builds the hand-written kernels from `parseable_tpu_torch/csrc/`, holds
every regime of each against its plain PyTorch version on the card (phase
2; with the regimes side by side at the shapes where the rules switch,
kernels A, B and K7 at the block-local fold's 2^17-2^22 groups, and
the fold's front half, K3, bit for bit on programs that use every opcode
over NaN, NULL, f64 values next to their literals and wrapping times, on
16-byte-aligned columns and on columns one element off), answers ROADMAP
list 3's repaired repros on the "gpu" engine on the card and on the "cpu"
engine (phase 9: the same rows, no block off the card), writes an access-
log lake of 2^23 rows (8 one-minute Parquet files of 2^20 rows, the shape
of `bench.py`'s "default" profile) through the port's own sync path, which
also seeds the encoded-block cache (phase 3), and answers four GROUP BY
queries and two log-browsing selects (their WHERE mask on K3a) on the
port's "cpu" engine and on its "gpu" engine in four cache states: cold
(device hot set and encoded-block cache empty), page-cache warm (no
encoded-block cache: Parquet read and encode again), disk-warm (the
encoded-block cache serves) and device-warm (the hot set serves), with a
profiled page-cache-warm and device-warm run each whose device busy time
is broken down into copies, the hand kernels and other kernels (phase 4).
Phase 7 does the same with two dashboard queries with stddev, var,
approximate percentiles, count(distinct) and approx_distinct, through the
statistics kernels K5-K7 (`parseable_tpu_torch/csrc/stats.cu`). Phase 8
runs the groupby query twice under a hot-set budget below its blocks:
evictions, and the prefetcher shipping blocks on its own CUDA stream.
Phase 10 writes a lake of `bench.py`'s "highcard" profile (10,240 hosts,
102,400 paths; 8 files of 2^20 rows, a stream of its own) and answers
three high-cardinality GROUP BYs on both engines, cold, disk-warm and
device-warm: a dense one whose ORDER BY <aggregate> LIMIT picks its groups
on the card (K8, `csrc/topk.cu`), and two past the dense budget, folded
block-local (K3a's KEY_CODE, A, B and K7 at 2^20-2^21 groups a block; one
in pair mode) and merged as partial tables; K8 is held bit for bit against
its plain version on that query's accumulator and on a hazard set, in each
of its regimes, and timed beside torch.topk there and on topk_multicol's
accumulator from phase 4; its kernels a call come from the profiled
queries of phases 4 and 10.
Phases 4, 7, 8 and 10 run with the result cache off, and every GPU run
there must keep every block on the card under the link and host rates the
card has measured (`cpu_adaptive` 0). Phase 11 (after phase 8 on the
phase 3 lake, and at the end of phase 10 on its lake) pins a degraded link
profile: groupby, select_filter and hc_minute_path, cold, must fold every
block on the host with the CPU engine's answer, the background warmer must
land every routed block in the hot set, and the next run, on the measured
profile, must be device-warm; then, with a 64 MiB result cache, groupby
over an API time range must miss, then hit with the same table, a query
reaching the staging window must not use the cache, and a new minute
synced into the lake must evict the entry.
Phase 12 (after phase 11 on the phase 3 lake, and on phase 10's lake before
it goes) pins virtual device meshes on the card (4 shards, and 2 x 2 data x
groups; the real cards too where there are several): six of the lake's
queries disk-warm and device-warm and hc_minute_path device-warm must
equal their one-device answers and the CPU engine's, every block folded
row-sharded; then K10 (`csrc/mesh.cu`, the mesh's combine) is held bit for
bit against its plain version on the partials the phase gave it and on a
hazard set, and timed.
Phase 5 checks and times each kernel on the inputs the main path gave it
(one block per shape, recorded in phases 4 and 7; K3 on each query's own
block) and kernels A and B also on uniform inputs of the same shape; K5-K7
there in the regime their rule picks and in the whole-copy rule's (a whole
copy a CTA), timed in turns, K7 also with a NaN and an inf value that must
stay in their own groups. Phase 6 runs the HTTP server: every ingest
request must take the native lane's columnar tier, and a parse line gives
each tier's parse-only rate on the same bodies. Phase 13 (after phase 6)
runs a cluster on one store: two ingest-mode servers as subprocesses
(`P_MODE=ingest python -m parseable_tpu_torch.server`, a Flight port each)
ack 2^20 events each, half moved into the lake by a stop and a start, half
left in staging, and a query-mode server here on the card answers phase
6's queries, a statistics query, a distinct-count query and select_filter
three ways: pushed down over Flight, pushed down over HTTP, and central
(the ingestors' staging windows pulled to the card). Every answer must
equal a numpy oracle of the events sent; a pushed-down GROUP BY must reach
both peers with no fallback and move no raw staging row; every central
query keeps each block on the card, and the phase must launch K3a, K3b,
A, B and K5-K7. Any failed check
raises, so the script exits non-zero; it needs one CUDA card and has no
CPU path.

Kernel times are device times: REPS calls enqueued back to back between two
CUDA events behind a device spin (`DeviceTimer`), L2-cold (rotating over
input copies that exceed L2 together) and L2-warm, cross-checked against
torch.profiler's device time per kernel it recorded (after phase 6 it
records only some of them: `profiler_kernels` counts them).

Output, one line per check, then:
- the card's name and power limit as nvidia-smi reports them;
- one JSON object {"kernels": [...]}: per kernel its launches on the main
  path, its error against the plain version, and its time, the plain
  version's time, one library call's time and the least time the card
  could take (bound), at the shapes the main path gave it;
- last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
from datetime import UTC, datetime, timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_BLOCK = 1 << 20  # rows of one minute file, and of one device block
MINUTES = 8  # 2^23 rows in all
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TC_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
L2_BYTES = 50e6  # H100 L2 cache
REPS = 20  # calls enqueued back to back in one timed window
REL_TOL = 2e-4  # f32 sums against f64 (tests/test_engine_fuzz.py model)
ABS_TOL = 1e-6
F32_MAX = 3.4e38

STREAM = "accesslog"
QUERIES = {
    # BASELINE config 2: time-bucketed GROUP BY aggregation
    "groupby": (
        "SELECT date_bin(interval '1 minute', p_timestamp) AS t, status, count(*) AS c, "
        "sum(bytes) AS b, avg(latency_ms) AS l FROM {stream} GROUP BY t, status"
    ),
    # BASELINE config 3: substring/LIKE filter (dictionary-LUT predicates)
    "regex_filter": (
        "SELECT status, count(*) AS c, avg(latency_ms) AS l FROM {stream} "
        "WHERE message LIKE '%error%' GROUP BY status"
    ),
    # BASELINE config 4: top-K + multi-column GROUP BY (ORDER BY/LIMIT on the host)
    "topk_multicol": (
        "SELECT path, host, count(*) AS c, sum(bytes) AS s FROM {stream} "
        "GROUP BY path, host ORDER BY s DESC LIMIT 10"
    ),
    # min/max through kernel B, behind a WHERE and a time bound
    "minmax": (
        "SELECT host, min(latency_ms) AS mn, max(bytes) AS mx FROM {stream} "
        "WHERE status >= 400 AND p_timestamp >= '2024-05-01T00:02:00Z' GROUP BY host"
    ),
}
# plain SELECTs: the WHERE mask on the card (K3a), rows filtered on the host;
# (query, the ORDER BY column whose order the answer must keep, or None)
SELECT_QUERIES = {
    # the console's log view
    "select_browse": (
        "SELECT p_timestamp, host, method, path, status, message FROM {stream} "
        "WHERE status >= 500 AND message LIKE '%error%' AND p_timestamp >= '2024-05-01T00:02:00Z' "
        "ORDER BY p_timestamp DESC LIMIT 1000",
        "p_timestamp",
    ),
    # no LIMIT: every mask bit reaches the answer
    "select_filter": (
        "SELECT host, path, status, latency_ms FROM {stream} WHERE host IN ('10.0.0.1', "
        "'10.0.1.2') AND NOT (path LIKE '%resource1%') AND latency_ms > 250",
        None,
    ),
}
BASE = datetime(2024, 5, 1, 0, 0, tzinfo=UTC)

# ROADMAP list 3, items 1-4: wrong answers of the GPU engine that the port
# repaired, as (item, case, WHERE or None, API time range or None) over
# `list3_table`. Each must answer as the CPU engine does, in a select and
# under a GROUP BY: on the card in phase 9, through the kernels' plain
# versions in tests/test_torch_executor.py (which holds items 1-3 against
# the JAX CPU engine too; item 4 rounds where the JAX package floors).
LIST3_RANGE = ("2024-05-01T10:00:00.000700Z", "2024-05-01T10:10:00.000700Z")
LIST3 = [
    ("strings", "like-newline-inside", "message LIKE '%error%'", None),
    ("strings", "like-newline-after", "message LIKE '%error'", None),
    ("strings", "like-underscore-newline", "message LIKE 'a_b'", None),
    ("strings", "regex-dollar-newline", "regexp_like(message, 'error$')", None),
    ("strings", "regex-digit-arabic", "regexp_like(message, '\\d')", None),
    ("f64", "eq-2^24+1", "bytes = 16777217", None),
    ("f64", "gt-2^31", "bytes > 2147483648", None),
    ("f64", "gt-250", "lat > 250", None),
    ("f64", "gt-0", "lat > 0", None),
    ("f64", "in", "lat IN (250, 12.3)", None),
    ("null", "ne-null", "host != NULL", None),
    ("null", "not-eq-null", "NOT (host = NULL)", None),
    ("subms", "api-range", None, LIST3_RANGE),
    ("subms", "ge-lt", f"p_timestamp >= '{LIST3_RANGE[0]}' AND p_timestamp < '{LIST3_RANGE[1]}'",
     None),
    ("subms", "gt-le", f"p_timestamp > '{LIST3_RANGE[0]}' AND p_timestamp <= '{LIST3_RANGE[1]}'",
     None),
    ("subms", "between", f"p_timestamp BETWEEN '{LIST3_RANGE[0]}' AND '{LIST3_RANGE[1]}'", None),
    ("subms", "eq-and-not-eq", f"p_timestamp = '{LIST3_RANGE[0]}' OR NOT (p_timestamp = "
     f"'{LIST3_RANGE[1]}') AND host = 'h1'", None),
]


def list3_table(pa):
    """The rows of list 3's repros: messages with newlines and Arabic-Indic
    digits, integers at 2^24 + 1 and past 2^31, f64 values next to 250 and
    at 1e-46, NULL hosts, and ms times at and next to the sub-ms bounds."""
    base = datetime(2024, 5, 1, 10, 0)
    ms = [0, 1, 300_000, 600_000, 600_001, 2, 3, 599_999, 4, 5]
    return pa.table({
        "p_timestamp": pa.array([base + timedelta(milliseconds=m) for m in ms], pa.timestamp("ms")),
        "message": pa.array(["foo\nerror at x", "error\n", "a\nb", "error: timeout", "\u0663\u0664",
                             "ok", None, "error", "x", "err\nor"]),
        "host": pa.array(["h0", "h1", None, "h0", "h1", "h2", "h0", "h1", "h2", None]),
        "bytes": pa.array([16777216, 16777217, 2147483649, 2147483648, 5, 7, None, 16777217, 0, 1],
                          pa.int64()),
        "lat": pa.array([250.0, 250.00000001, 1e-46, 249.99999999, 12.3, 0.0, None,
                         float("nan"), 250.0, -1e-46]),
    })


def list3_queries(where: str | None) -> list[str]:
    """A select and a GROUP BY behind `where`."""
    w = f" WHERE {where}" if where else ""
    return [f"SELECT p_timestamp, host, message, bytes, lat FROM t{w}",
            f"SELECT host AS g0, count(*) AS c0, count(lat) AS c1 FROM t{w} GROUP BY g0"]


def list3_rows(rows: list[dict]) -> list[str]:
    """Rows in an order and a form two engines' answers compare in."""
    return sorted(repr(sorted(r.items())) for r in rows)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class DeviceTimer:
    """Device time per call: REPS calls enqueued back to back between two
    CUDA events, behind a device spin long enough that the host runs ahead,
    so host enqueue gaps stay out of the window. A window whose start event
    had already passed on the device when the host finished enqueueing it
    may hold such gaps (the host was slowed, e.g. by other threads holding
    the GIL): it is timed again behind a spin four times as long, up to
    three times (`reruns` counts them, `dry` the windows that never got
    ahead). Rotating over `copies` sets of inputs that together exceed L2
    times the call L2-cold."""

    def __init__(self, torch):
        self.torch = torch
        torch.cuda.synchronize()
        start, end = self._events()
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 2_000_000 / start.elapsed_time(end)
        self.reruns = 0
        self.dry = 0

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def ms(self, fn, copies: int = 1, warmup: int = 3) -> float:
        torch = self.torch
        for k in range(warmup):
            fn(k % copies)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k in range(REPS):
            fn(k % copies)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3  # at least the enqueue time of REPS calls
        spin_ms = 2 * host_ms + 0.1
        for attempt in range(4):
            start, end = self._events()
            torch.cuda._sleep(int(spin_ms * self.cycles_per_ms))
            start.record()
            for k in range(REPS):
                fn(k % copies)
            end.record()
            ahead = not start.query()  # the device still spun when the window was enqueued
            end.synchronize()
            if ahead:
                break
            if attempt == 3:
                self.dry += 1
            else:
                self.reruns += 1
                spin_ms *= 4
        return start.elapsed_time(end) / REPS


def profiled_ms(torch, fn, names: tuple[str, ...], calls: int = 10):
    """Device time per kernel of the kernels whose names hold one of `names`,
    from torch.profiler over `calls` warm calls (one kernel a call), and the
    number of such kernels it recorded; (None, 0) if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(0)
        torch.cuda.synchronize()
    us, seen = 0.0, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and any(n in ev.key for n in names):
            us += getattr(ev, "self_device_time_total", 0.0)
            seen += ev.count
    return (us / seen / 1e3 if seen else None), seen


def n_copies(nbytes: float) -> int:
    """Input sets to rotate over so that together they exceed L2 threefold."""
    return max(2, min(64, math.ceil(3 * L2_BYTES / nbytes)))


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations over
    their peak rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def timed(timer, fns: dict, copies: int, reset=None) -> dict:
    """Each call of `fns` L2-cold (rotating `copies` input sets) and L2-warm
    (one set); `reset()`, when given, runs before each timing, outside it."""
    res = {}
    for suffix, n in (("", copies), ("_l2_warm", 1)):
        for key, fn in fns.items():
            if reset:
                reset()
            res[key + suffix] = timer.ms(fn, n)
    return res


# ---------------------------------------------------------------- kernels


def uniform_a(torch, r: int, n: int, g: int, gen):
    """Kernel A inputs with uniform ids, with rows as the main path builds
    them: row mask, 0/1 validity, masked sums."""
    ids = torch.randint(0, g, (n,), generator=gen, dtype=torch.int32)
    return ids.cuda(), a_rows(torch, r, n, gen)


def a_rows(torch, r: int, n: int, gen):
    """Kernel A's value rows as the main path builds them: row mask, 0/1
    validity, masked sums (on the card)."""
    mask = torch.rand(n, generator=gen) < 0.9
    n_valid = (r - 1) // 2
    rows = torch.cat(
        [
            mask[None].float(),
            (torch.rand(n_valid, n, generator=gen) < 0.8).float() * mask[None],
            torch.rand(r - 1 - n_valid, n, generator=gen) * 50_000 * mask[None],
        ]
    )
    return rows.cuda().contiguous()


def uniform_b(torch, k: int, n: int, g: int, gen):
    """Kernel B inputs; a quarter of the groups get no row, so their
    identities (+-inf) must show."""
    ids = torch.randint(0, max(1, (3 * g) // 4), (n,), generator=gen, dtype=torch.int32)
    mask = torch.rand(n, generator=gen) < 0.9
    vals = torch.randn(k, n, generator=gen) * 1000
    valid = torch.rand(k, n, generator=gen) < 0.8
    return tuple(t.cuda().contiguous() for t in (ids, vals, valid, mask))


def check_additive(torch, ids, rows, g: int, out, plain, what: str) -> dict:
    """Kernel A's output against a float64 sum (rows of 0/1 exact, others
    rel 2e-4, non-finite entries equal) and against its plain version."""
    r = rows.shape[0]
    inside = (ids >= 0) & (ids < g)
    ref64 = torch.zeros((r, g), dtype=torch.float64, device=rows.device)
    ref64.index_add_(1, ids[inside].long(), rows[:, inside].double())
    counts = ((rows == 0) | (rows == 1)).all(dim=1)
    check(torch.equal(out[counts].double(), ref64[counts]), f"kernel A counts not exact: {what}")
    inf = torch.isinf(ref64)
    check(
        torch.equal(torch.isnan(out), torch.isnan(ref64))
        and torch.equal(out[inf].double(), ref64[inf]),
        f"kernel A non-finite entries differ: {what}",
    )
    fin = torch.isfinite(ref64)
    rel = ((out.double() - ref64).abs() / ref64.abs().clamp_min(1.0))[fin].max().item()
    check(rel <= REL_TOL, f"kernel A sums rel err {rel} > {REL_TOL}: {what}")
    check(
        bool(torch.allclose(out, plain, rtol=REL_TOL, atol=ABS_TOL, equal_nan=True)),
        f"kernel A disagrees with its plain version: {what}",
    )
    both = torch.isfinite(out) & torch.isfinite(plain)
    err = (out - plain)[both].abs().max().item() if both.any() else 0.0
    return {"max_abs_err": err, "max_rel_err_f64": rel}


def kernel_a_case(torch, G, timer, ids, rows, g: int, inputs: str,
                  regime: str | None = None) -> dict:
    """Kernel A vs its plain version and a float64 sum, then timed L2-cold
    and L2-warm beside its plain version and index_add_."""
    r, n = rows.shape
    regime = regime or G.additive_regime(r, g)
    res = {"shape": f"R={r} N={n} G={g}", "inputs": inputs, "regime": regime}
    res.update(
        check_additive(torch, ids, rows, g, G.additive_groupby(ids, rows, g, regime=regime),
                       G.additive_groupby_plain(ids, rows, g), f"R={r} G={g} {regime} {inputs}")
    )
    nbytes = 4 * n * (r + 1) + 4 * r * g
    copies = n_copies(nbytes)
    sets = [(ids, rows)] + [(ids.clone(), rows.clone()) for _ in range(copies - 1)]
    lib_out = torch.zeros(r, g, device=rows.device)
    fns = {
        "ms": lambda k: G.additive_groupby(*sets[k], g, regime=regime),
        "plain_ms": lambda k: G.additive_groupby_plain(*sets[k], g),
        "library_ms": lambda k: lib_out.index_add_(1, *sets[k]),
    }
    res.update(timed(timer, fns, copies))
    res["profiler_ms"], res["profiler_kernels"] = profiled_ms(torch, fns["ms"], ("additive",))
    res["sum_ms"] = stream_sum_ms(torch, timer, nbytes)
    if regime == "tensor":
        ops = 2 * (-(-g // 16) * 16) * G.TC_COLS * n
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, ops, TC_OPS_PER_S)
    else:
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, r * n)
    res["copies"] = copies
    return res


def check_minmax(torch, G, ids, vals, valid, mask, g: int, n_min: int, what: str,
                 decode: str | None = None) -> float:
    """Kernel B against its plain version, bit for bit (+-inf and NaN
    included); returns the largest difference over the finite entries."""
    mn, mx = G.minmax_groupby(ids, vals, valid, mask, g, n_min, decode=decode)
    pmn, pmx = G.minmax_groupby_plain(ids, vals, valid, mask, g, n_min)
    check(torch.equal(mn, pmn) and torch.equal(mx, pmx), f"kernel B not exact: {what}")
    got, want = torch.cat([mn, mx]), torch.cat([pmn, pmx])
    fin = torch.isfinite(want)
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def kernel_b_case(torch, G, timer, ids, vals, valid, mask, g: int, n_min: int,
                  inputs: str) -> dict:
    """Kernel B vs its plain version, bit for bit, then timed L2-cold and
    L2-warm beside its plain version and two scatter_reduce_ calls."""
    k, n = vals.shape
    err = check_minmax(torch, G, ids, vals, valid, mask, g, n_min, f"K={k} G={g} {inputs}")
    nbytes = n * (4 + 5 * k + 1) + 4 * k * g
    copies = n_copies(nbytes)
    sets = [(ids, vals, valid, mask)] + [
        tuple(t.clone() for t in (ids, vals, valid, mask)) for _ in range(copies - 1)
    ]
    idx = [s[0].long()[None].expand(k, n) for s in sets]
    lo = [torch.where(s[2][:n_min] & s[3][None], s[1][:n_min], F32_MAX) for s in sets]
    hi = [torch.where(s[2][n_min:] & s[3][None], s[1][n_min:], -F32_MAX) for s in sets]
    lib_mn = torch.full((n_min, g), math.inf, device=vals.device)
    lib_mx = torch.full((k - n_min, g), -math.inf, device=vals.device)

    def library(j):
        lib_mn.scatter_reduce_(1, idx[j][:n_min], lo[j], reduce="amin", include_self=True)
        lib_mx.scatter_reduce_(1, idx[j][n_min:], hi[j], reduce="amax", include_self=True)

    fns = {
        "ms": lambda j: G.minmax_groupby(*sets[j], g, n_min),
        "plain_ms": lambda j: G.minmax_groupby_plain(*sets[j], g, n_min),
        "library_ms": library,
    }
    res = {"shape": f"K={k} n_min={n_min} N={n} G={g}", "inputs": inputs,
           "regime": "shared" if k * g * 4 <= G.SMEM_BUDGET else "global",
           "decode": G.minmax_decode(k, g), "max_abs_err": err}
    res.update(timed(timer, fns, copies))
    res["profiler_ms"], res["profiler_kernels"] = profiled_ms(torch, fns["ms"], ("minmax",))
    res["sum_ms"] = stream_sum_ms(torch, timer, nbytes)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, k * n)
    res["copies"] = copies
    return res


def edge_cases(torch, G, gen) -> None:
    """Untimed checks in every regime: ids out of range, half of the rows in
    one group, NaN and +-inf values confined to their groups (kernel A),
    +-F32_MAX and +-inf values (kernel B)."""
    n = 1 << 18
    for r, g, regime in ((3, 8, "tensor"), (5, 64, "tensor"), (5, 128, "tensor"),
                         (5, 2048, "shared"), (3, 8192, "shared"), (5, 65536, "global")):
        ids, rows = uniform_a(torch, r, n, g, gen)
        ids[: n // 2] = 3 % g
        ids[::97] = -1
        ids[::89] = g
        rows[-1, 5], rows[-1, 6], rows[-1, 7], rows[-1, 10] = math.nan, math.inf, -math.inf, F32_MAX
        res = check_additive(torch, ids, rows, g, G.additive_groupby(ids, rows, g, regime=regime),
                             G.additive_groupby_plain(ids, rows, g), f"edge R={r} G={g} {regime}")
        log(f"phase 2 edge additive_groupby R={r} G={g} {regime}: {json.dumps(res)}")
    for g in (64, 8192, 65536):
        ids, vals, valid, mask = uniform_b(torch, 2, n, g, gen)
        ids[: n // 2] = 1
        ids[::97] = -1
        ids[::89] = g
        vals[0, ::1001] = F32_MAX
        vals[1, ::1003] = -F32_MAX
        vals[0, 3], vals[1, 4] = math.inf, -math.inf
        mn, mx = G.minmax_groupby(ids, vals, valid, mask, g, 1)
        pmn, pmx = G.minmax_groupby_plain(ids, vals, valid, mask, g, 1)
        check(torch.equal(mn, pmn) and torch.equal(mx, pmx), f"edge kernel B not exact at G={g}")
        log(f"phase 2 edge minmax_groupby K=2 G={g}: exact")


# ids of the block-local fold's blocks (local_ids)
LOCAL_IDS = ("uniform", "minute-band", "near-unique", "one-hot-group", "outside")


def local_ids(torch, n: int, g: int, kind: str, gen):
    """Ids as the block-local fold gives them (on the card): uniform;
    hc_minute_path's one-minute band (one time bin of 8, first key minor,
    over 102,400 path codes: every 8th group); pair mode's near-unique codes;
    one hot group (9 rows in 10); two thirds outside [0, G)."""
    if kind == "uniform":
        ids = torch.randint(0, g, (n,), generator=gen)
    elif kind == "minute-band":
        ids = 3 + 8 * torch.randint(0, min(102_400, g // 8), (n,), generator=gen)
    elif kind == "near-unique":
        ids = torch.randperm(max(g, n), generator=gen)[:n] % g
    elif kind == "one-hot-group":
        ids = torch.where(torch.rand(n, generator=gen) < 0.9, g // 2,
                          torch.randint(0, g, (n,), generator=gen))
    else:
        ids = torch.randint(-g, 2 * g, (n,), generator=gen)
    return ids.to(torch.int32).cuda()


def unaligned(torch, x):
    """A contiguous copy of `x` whose data starts one element past a 16-byte
    boundary (the kernels' scalar loads)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def local_fold_hazards(torch, G, SC, gen) -> None:
    """Untimed: A and K7 in their "global" regime (the block-local fold's)
    against their plain versions (A within rel 2e-4 of a f64 sum, counts
    exact; K7 `m2_close`) at G = 2^17, 2^20 and 2^22, on every kind of ids
    of LOCAL_IDS, R = 1, 3, 4, 5 and 8 value rows (K7 Q = 1 and 2), with a
    NaN and +-inf in the last value row (each in its own group), and once
    more a ragged block (N = 2^20 - 3) one element off 16-byte alignment."""
    for g in (1 << 17, 1 << 20, 1 << 22):
        worst, cases = 0.0, 0
        for kind in (*LOCAL_IDS, "ragged, unaligned"):
            ragged = kind.startswith("ragged")
            n = N_BLOCK - 3 if ragged else N_BLOCK
            ids = local_ids(torch, n, g, "uniform" if ragged else kind, gen)
            for r in (1, 3, 4, 5, 8):
                rows = a_rows(torch, r, n, gen)
                if r >= 3:
                    rows[-1, 5], rows[-1, 6], rows[-1, 7] = math.nan, math.inf, -math.inf
                i, x = (unaligned(torch, ids), unaligned(torch, rows)) if ragged else (ids, rows)
                check(G.additive_regime(r, g) == "global", f"kernel A at R={r} G={g}")
                res = check_additive(torch, i, x, g, G.additive_groupby(i, x, g),
                                     G.additive_groupby_plain(i, x, g), f"local R={r} G={g} {kind}")
                worst, cases = max(worst, res["max_rel_err_f64"]), cases + 1
            for q in (1, 2):
                _, vals, valid, mask, mean = (t.cuda() for t in stats_inputs(
                    torch, SC, "centered_m2", (q, n, g), gen))
                data = [ids, m2_poisoned(torch, ids, vals, valid, mask, g), valid, mask]
                if ragged:
                    data = [unaligned(torch, d) for d in data]
                check(SC.m2_regime(q, g) == "global", f"K7 at Q={q} G={g}")
                got = SC.centered_m2(*data, mean)
                check(m2_close(torch, got, SC.centered_m2_plain(*data, mean))
                      and int((~torch.isfinite(got)).sum()) <= 2,
                      f"K7 disagrees with its plain version: Q={q} G={g} {kind}")
                cases += 1
        log(f"phase 2 local fold hazards G={g}: {cases} cases of A and K7 agree with their plain "
            f"versions (A's largest rel err against f64 {worst:.3g})")


# kernel A's rule switches between the tensor and shared regimes around these
# shapes (groupby_cuda.additive_regime); the main path's are (3, 64) and (5, 64)
RULE_SHAPES_A = ((3, 16), (3, 32), (3, 48), (3, 64), (5, 48), (5, 64), (5, 80), (5, 96))
# kernel B's decode placement switches at MINMAX_DECODE_IN_KERNEL entries
RULE_SHAPES_B = (64, 512, 2048, 4096, 8192, 65536)


def rule_sweep(torch, G, timer, gen) -> None:
    """Both sides of each rule, checked against the plain version and timed
    (L2-cold / L2-warm us) in one run: kernel A's tensor and shared regimes
    at the shapes where its rule switches, on uniform ids and on the main
    path's skew (5 live ids, half of the rows in one); kernel B's in-kernel
    and separate-launch decode at K=2 around its threshold."""
    for r, g in RULE_SHAPES_A:
        for kind in ("uniform", "skewed"):
            ids, rows = uniform_a(torch, r, N_BLOCK, g, gen)
            if kind == "skewed":
                live = torch.randperm(g, generator=gen)[:5].to(torch.int32)
                pick = torch.randint(0, 5, (N_BLOCK,), generator=gen)
                pick[torch.rand(N_BLOCK, generator=gen) < 0.5] = 0
                ids = live[pick].cuda()
            copies = n_copies(4 * N_BLOCK * (r + 1))
            sets = [(ids, rows)] + [(ids.clone(), rows.clone()) for _ in range(copies - 1)]
            fns = {}
            for regime in ("tensor", "shared"):
                check_additive(torch, ids, rows, g, G.additive_groupby(ids, rows, g, regime=regime),
                               G.additive_groupby_plain(ids, rows, g), f"rule R={r} G={g} {regime}")
                fns[regime] = lambda k, regime=regime: G.additive_groupby(*sets[k], g, regime=regime)
            t = timed(timer, fns, copies)
            us = {k: round(v * 1e3, 2) for k, v in t.items()}
            log(f"phase 2 rule additive_groupby R={r} G={g} {kind}: rule picks "
                f"{G.additive_regime(r, g)}, us {json.dumps(us)}")
    for g in RULE_SHAPES_B:
        ids, vals, valid, mask = uniform_b(torch, 2, N_BLOCK, g, gen)
        copies = n_copies(N_BLOCK * 15)
        sets = [(ids, vals, valid, mask)] + [
            tuple(t.clone() for t in (ids, vals, valid, mask)) for _ in range(copies - 1)
        ]
        fns = {}
        for decode in ("kernel", "launch"):
            check_minmax(torch, G, ids, vals, valid, mask, g, 1, f"rule G={g} {decode}", decode)
            fns[decode] = lambda j, decode=decode: G.minmax_groupby(*sets[j], g, 1, decode=decode)
        t = timed(timer, fns, copies)
        us = {k: round(v * 1e3, 2) for k, v in t.items()}
        log(f"phase 2 rule minmax_groupby K=2 G={g} uniform: rule picks "
            f"{G.minmax_decode(2, g)}, us {json.dumps(us)}")


# --------------------------------------------------------------------- K3

K3_KERNELS = ("mask_ids", "stack_operands")


# f64 values next to the f64 literals of `k3_programs`: 2^24 + 1 (not an
# f32), values two f64 ulps and 1e-8 off 250, 1e-46 (an f32 0), NaN, -0.0
F64_HAZARDS = (2.0**24 + 1, 2.0**24, 250.0, 250.00000001, 249.99999999, 250.0 + 2**-44,
               1e-46, -1e-46, 0.0, -0.0, float("nan"), float("inf"), 2147483649.0, 12.3)


def k3_block(torch, np, n: int, offset: int, rng) -> dict:
    """Every column kind of a K3 program on the card, each a view `offset`
    elements into a larger buffer (offset 0: 16-byte aligned, the kernels'
    vector variant where N is a multiple of 512; else aligned to its element
    size only, their scalar variant): int8 codes over the whole signed
    range, int16 and int32 codes, f32 values with NaN, +-inf, -0.0 and
    NULLs, f64 values with `F64_HAZARDS` and NULLs, int32 times out to
    +-2^31 (negative ones among them) with NULLs, and a padding mask."""
    f = (rng.standard_normal(n) * 100).astype(np.float32)
    u = rng.random(n)
    f[u < 0.05] = np.nan
    f[(u >= 0.05) & (u < 0.07)] = np.inf
    f[(u >= 0.07) & (u < 0.09)] = -np.inf
    f[(u >= 0.09) & (u < 0.12)] = -0.0
    t = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    t[: n // 2] = rng.integers(-200_000, 200_000, n // 2)
    t[:4] = [2**31 - 1, -(2**31), -1, 0]
    d = rng.standard_normal(n) * 300
    hazard = rng.random(n) < 0.4
    d[hazard] = rng.choice(np.array(F64_HAZARDS), int(hazard.sum()))
    cols = {
        "c8": rng.integers(-128, 128, n).astype(np.int8),
        "c16": rng.integers(0, 1000, n).astype(np.int16),
        "c32": rng.integers(0, 5000, n).astype(np.int32),
        "f": f, "t": t, "d": d,
        "f__valid": rng.random(n) < 0.9, "t__valid": rng.random(n) < 0.95,
        "d__valid": rng.random(n) < 0.9,
        "c16__valid": rng.random(n) < 0.8, "__rowmask": np.arange(n) < n - 37,
    }
    out = {}
    for k, a in cols.items():
        buf = np.zeros(len(a) + offset, a.dtype)
        buf[offset:] = a
        out[k] = torch.from_numpy(buf).cuda()[offset:]
    return out


def k3_programs(F, np, rng) -> list:
    """(name, Program) pairs over `k3_block`'s columns that use every opcode
    and operand row: each leaf alone under each comparison (NaN, -0.0 and
    +-inf literals among them), the connectives over NULLs, then the keys
    (dictionary remaps with their 2^30 sentinel, time bins with a wrapping
    shift and a negative offset, a block's own codes and pair codes, a mesh
    window's shift and mask) and every kind of operand row."""
    luts = {"c8": rng.random(256) < 0.5, "c16": rng.random(1024) < 0.3,
            "c32": rng.random(8192) < 0.5}
    out = []

    def program(name, build):
        prog = F.Program()
        slot = {c: prog.slot(c, f"{c}__valid" if c in ("f", "t", "c16", "d") else None)
                for c in ("c8", "c16", "c32", "f", "t", "d")}
        build(prog, slot)
        out.append((name, prog))

    def connectives(p, s):  # NOT ((f > 0 OR c16) AND NOT t < 0) OR (f IS NULL AND false)
        p.cmp_f32(s["f"], ">", 0.0)
        p.lut(s["c16"], luts["c16"])
        p.or_()
        p.cmp_i32(s["t"], "<", 0)
        p.not_()
        p.and_()
        p.not_()
        p.is_null(s["f"])
        p.const(False)
        p.and_()
        p.or_()
        p.is_null(p.slot(None, "__rowmask"), negated=True)
        p.and_()

    def keys_and_rows(p, s):
        connectives(p, s)
        remap8 = rng.integers(0, 70, 256).astype(np.int32)
        remap8[::9] = 2**30
        p.key_dict(s["c8"], remap8, 64, 1)
        p.key_time(s["t"], 2**30 - 5, 7, -3, 16, 64)
        p.key_time(s["t"], 0, 60_000, 2, 8, 1024)
        p.key_dict(s["c16"], rng.integers(0, 3, 1024).astype(np.int32), 4, 8192)
        p.row(F.ROW_MASK)
        for nan in (False, True):
            p.row(F.ROW_LIVE, s["f"], nan_aware=nan)
            p.row(F.ROW_LIVE, s["f"], nan_aware=nan, bool_out=True)
        p.row(F.ROW_MASKED, s["f"])
        p.row(F.ROW_VALUE, s["f"])
        p.row(F.ROW_LIVE, s["c16"])
        p.row(F.ROW_LIVE, s["c32"], bool_out=True)

    def own_codes(p, s):  # the local fold's keys: own codes, a time bin, pair codes
        p.const(True)
        p.key_code(s["c8"], 64, 1)  # int8 codes over the whole signed range
        p.key_time(s["t"], 0, 60_000, -2, 8, 64)
        p.key_code(s["c16"], 512, 512)
        p.key_code(s["c32"], 1 << 12, 1 << 18)  # a pair key: cap = its group count
        p.row(F.ROW_MASK)
        p.row(F.ROW_MASKED, s["f"])

    def nulls(p, s):  # NOT (NOT NULL OR (d > 250 AND NULL) OR (NULL AND f < 1e-46))
        p.const(True, known=False)
        p.not_()
        p.cmp_f64(s["d"], ">", 250.0)
        p.const(False, known=False)
        p.and_()
        p.or_()
        p.const(True, known=False)
        p.cmp_f64(s["f"], "<", 1e-46)
        p.and_()
        p.or_()
        p.not_()

    for c in ("c8", "c16", "c32"):
        program(f"lut {c}", lambda p, s, c=c: p.lut(s[c], luts[c]))
    for op in F.CMP:
        for v in (0.0, -0.0, 1.5, float("nan"), float("inf"), -float("inf")):
            program(f"f32 {op} {v}", lambda p, s, op=op, v=v: p.cmp_f32(s["f"], op, v))
        for v in (-5, 0, 2**31 - 2, -(2**31) + 2):
            program(f"i32 {op} {v}", lambda p, s, op=op, v=v: p.cmp_i32(s["t"], op, v))
        # f64 compares over the f64 column and over the f32 one (read as f64)
        for v in (250.0, 2.0**24 + 1, 1e-46, 0.0, -0.0, float("nan"), 2147483648.0, 12.3):
            program(f"f64 {op} {v}", lambda p, s, op=op, v=v: p.cmp_f64(s["d"], op, v))
        for v in (250.00000001, 16777217.0, 1e-46, 1.5):
            program(f"f64 over f32 {op} {v}", lambda p, s, op=op, v=v: p.cmp_f64(s["f"], op, v))
    items = [1.5, -0.0, float("inf"), float("nan")]
    items64 = [250.0, 12.3, 2.0**24 + 1, 1e-46, float("nan"), -0.0]
    for neg in (False, True):
        program(f"in {neg}", lambda p, s, neg=neg: p.in_f32(s["f"], items, neg))
        program(f"in f64 {neg}", lambda p, s, neg=neg: p.in_f64(s["d"], items64, neg))
        program(f"in f64 over f32 {neg}", lambda p, s, neg=neg: p.in_f64(s["f"], items64, neg))
        program(f"null {neg}", lambda p, s, neg=neg: p.is_null(s["f"], neg))
        program(f"const {neg}", lambda p, s, neg=neg: p.const(neg))
        program(f"const NULL {neg}", lambda p, s, neg=neg: p.const(neg, known=False))
    def windowed(lo, n):  # a groups-sharded mesh's window over dictionary x time ids
        remap = rng.integers(0, 70, 256).astype(np.int32)

        def build(p, s):
            connectives(p, s)
            p.key_dict(s["c8"], remap, 64, 1)
            p.key_time(s["t"], 0, 60_000, 2, 8, 64)
            p.key_window(lo, n)
            p.row(F.ROW_MASK)
            p.row(F.ROW_MASKED, s["f"])
        return build

    program("connectives", connectives)
    program("NULL connectives", nulls)
    program("own codes", own_codes)
    for lo, n in ((0, 128), (256, 128), (384, 256)):
        program(f"window {lo} {n}", windowed(lo, n))
    program("keys and rows", keys_and_rows)  # last: its verdicts are mixed
    return out


def k3_inputs(torch, prog, block: dict, n: int) -> tuple:
    """K3a's arguments for `prog` over `block`: (words, slots, n, with_ids)."""
    words = torch.from_numpy(prog.pack()).cuda()
    slots = [(block[v] if v else None, block[m] if m else None) for v, m in prog.slots]
    return words, slots, n, True


def clone_args(data: tuple) -> tuple:
    """A K3 call's arguments with every tensor cloned (slots included)."""

    def one(x):
        if isinstance(x, list):
            return [tuple(one(t) for t in slot) for slot in x]
        return x.clone() if hasattr(x, "clone") else x

    return tuple(one(x) for x in data)


def k3_check(torch, F, kind: str, data: tuple, what: str) -> float:
    """A K3 kernel against its plain version on the same inputs, bit for
    bit (NaN payloads included); returns the largest difference (0.0)."""
    if kind == "mask_ids":
        words, slots, n, with_ids = data
        mask, ids = F.mask_ids(words, slots, n, with_ids=with_ids)
        pmask, pids = F.mask_ids_plain(words, slots, n, with_ids)
        check(torch.equal(mask, pmask), f"K3a mask not exact: {what}")
        check(ids is None or torch.equal(ids, pids), f"K3a ids not exact: {what}")
        return 0.0
    words, slots, mask, nf, nb = data
    frows, brows = F.stack_operands(words, slots, mask, nf, nb)
    pf, pb = F.stack_operands_plain(words, slots, mask, nf, nb)
    check(torch.equal(frows.view(torch.int32), pf.view(torch.int32)) and torch.equal(brows, pb),
          f"K3b rows not exact: {what}")
    return 0.0


def k3_bytes(F, kind: str, data: tuple) -> tuple[float, int]:
    """(bytes the call must move, operations): each array it reads once
    (values, validity, LUTs and remaps, the program, the mask) and each
    output written once; one operation a row and instruction or row op."""
    words, slots = data[0], data[1]
    ins, ops, _, _ = F.decode(words.cpu())
    n = data[2] if kind == "mask_ids" else data[2].shape[0]
    read: dict[int, int] = {words.data_ptr(): words.numel() * 4}

    def take(t):
        if t is not None:
            read[t.data_ptr()] = t.numel() * t.element_size()

    if kind == "mask_ids":
        compares = (F.LUT, F.CMP_F32, F.CMP_I32, F.IN_F32, F.NOT_IN_F32, F.CMP_F64, F.IN_F64,
                    F.NOT_IN_F64)
        for op, slot, a, b, *_ in ins:
            values, valid = slots[slot] if slots else (None, None)
            if op in compares or (op in (F.KEY_DICT, F.KEY_TIME, F.KEY_CODE) and data[3]):
                take(values)
            if op in compares or op in (F.IS_NULL, F.NOT_NULL):
                take(valid)
        out = n * (1 + (4 if data[3] else 0))
        return sum(read.values()) + out, n * max(1, len(ins))
    mask, nf, nb = data[2], data[3], data[4]
    take(mask)
    for op, slot, flags, _ in ops:
        values, valid = slots[slot] if op != F.ROW_MASK else (None, None)
        if op in (F.ROW_LIVE, F.ROW_MASKED):
            take(valid)
        if op in (F.ROW_MASKED, F.ROW_VALUE) or flags & F.NAN_AWARE:
            take(values)
    return sum(read.values()) + n * (4 * nf + nb), n * max(1, len(ops))


def host_ms(torch, fn, copies: int) -> float:
    """Host wall per call to completion (a plain version that reads its
    program back on the host syncs inside, so device events would time its
    gaps too)."""
    fn(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for k in range(REPS):
        fn(k % copies)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / REPS


def k3_case(torch, F, timer, kind: str, data: tuple, inputs: str) -> dict:
    """A K3 kernel vs its plain version, bit for bit, then timed L2-cold and
    L2-warm (device time) beside its plain version (host wall) and, for
    K3b, one torch.cat that builds the same f32 matrix from ready rows."""
    res = {"inputs": inputs, "regime": None}
    res["max_abs_err"] = k3_check(torch, F, kind, data, f"{kind} {inputs}")
    nbytes, ops = k3_bytes(F, kind, data)
    copies = n_copies(nbytes)

    sets = [data] + [clone_args(data) for _ in range(copies - 1)]
    if kind == "mask_ids":
        words, slots, n, with_ids = data
        call = lambda d: F.mask_ids(d[0], d[1], d[2], with_ids=d[3])  # noqa: E731
        plain = lambda d: F.mask_ids_plain(*d)  # noqa: E731
        ins = F.decode(words.cpu())[0]
        res["shape"] = f"N={n} slots={len(slots)} instr={len(ins)} ids={with_ids}"
    else:
        words, slots, mask, nf, nb = data
        n = mask.shape[0]
        call = lambda d: F.stack_operands(*d)  # noqa: E731
        plain = lambda d: F.stack_operands_plain(*d)  # noqa: E731
        res["shape"] = f"N={n} slots={len(slots)} rows={nf}+{nb}"
    fns = {"ms": lambda k: call(sets[k])}
    if kind == "stack_operands" and nf:
        ready = [[r.clone() for r in plain(d)[0]] for d in sets]
        fns["library_ms"] = lambda k: torch.cat([r[None] for r in ready[k]])
    res.update(timed(timer, fns, copies))
    res.setdefault("library_ms", None)
    res["plain_ms"] = host_ms(torch, lambda k: plain(sets[k]), copies)
    res["profiler_ms"], res["profiler_kernels"] = profiled_ms(
        torch, fns["ms"], (KERNEL_SYMBOLS[kind],))
    res["sum_ms"] = stream_sum_ms(torch, timer, nbytes)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, ops)
    res["bytes"] = nbytes
    res["copies"] = copies
    return res


def k3_hazards(torch, F, timer, seed: int) -> None:
    """Phase 2: K3a and K3b against their plain versions, bit for bit, on
    every program of `k3_programs` twice: over 2^20 rows of 16-byte-aligned
    columns (the kernels' vector variant) and over 2^20 + 3 rows whose
    columns sit one element off their buffers' alignment (their scalar
    variant); the keys-and-rows program timed on the aligned block."""
    import numpy as np

    rng = np.random.default_rng(seed)
    programs = k3_programs(F, np, rng)
    for n, offset in ((N_BLOCK, 0), (N_BLOCK + 3, 1)):
        block = k3_block(torch, np, n, offset, rng)
        vector = None
        for name, prog in programs:
            data = k3_inputs(torch, prog, block, n)
            k3_check(torch, F, "mask_ids", data, name)
            vector = F.vector_ok(n, [t for slot in data[1] for t in slot if t is not None])
            if prog.n_frows + prog.n_brows:
                mask, _ = F.mask_ids(*data[:3])
                k3_check(torch, F, "stack_operands",
                         (data[0], data[1], mask, prog.n_frows, prog.n_brows), name)
        check(vector == (offset == 0), f"K3 variant on offset {offset}: vector {vector}")
        log(f"phase 2 K3 hazards: {len(programs)} programs exact on N={n}, views {offset} "
            f"element(s) off alignment ({'vector' if vector else 'scalar'} variant)")
    n = N_BLOCK
    block = k3_block(torch, np, n, 0, rng)
    name, prog = next((nm, pg) for nm, pg in programs if nm == "keys and rows")
    data = k3_inputs(torch, prog, block, n)
    res = k3_case(torch, F, timer, "mask_ids", data, "hazards")
    log(f"phase 2 mask_ids {json.dumps(res)}")
    mask, _ = F.mask_ids(*data[:3])
    res = k3_case(torch, F, timer, "stack_operands",
                  (data[0], data[1], mask, prog.n_frows, prog.n_brows), "hazards")
    log(f"phase 2 stack_operands {json.dumps(res)}")


# ---------------------------------------------------------------- K8

# the aggregates K8 orders by: (SELECT item, its kind); `TOPK_SQL` holds them
TOPK_ITEMS = (
    ("count(*)", "count_star"), ("count(v)", "count"), ("sum(v)", "sum"), ("avg(v)", "avg"),
    ("min(v)", "min"), ("max(v)", "max"), ("stddev(v)", "stddev"), ("var(v)", "var"),
)
TOPK_SQL = f"SELECT g, {', '.join(item for item, _ in TOPK_ITEMS)} FROM t GROUP BY g"
TOPK_POOL = (0.0, -0.0, 1.0, 2.0, 3.0, 7.5, -1.0, 100.0, 3.4e38, -3.4e38, 3.4028235e38,
             float("inf"), float("-inf"), float("nan"))


def topk_hazard_acc(np, rng, rows: int, g: int, count_rows: int, subnormals: bool = True):
    """A packed accumulator f32 [rows, g] of K8's hazards. Its first
    `count_rows` rows are counts, as the accumulator's count and per-agg
    count rows: small integers (ties at any cut), 0 in a fifth of the slots
    (an empty slot in row 0, a NULL aggregate elsewhere) and 1 in others (a
    NULL variance). In every other row half the values come from a pool
    (ties, NaN, +-inf, +-3.4e38, the largest f32, +-0.0), with subnormals
    among them, and the rest are random."""
    acc = (rng.standard_normal((rows, g)) * 1000).astype(np.float32)
    u = rng.random((rows, g))
    pool = np.array(TOPK_POOL, np.float32)
    acc[u < 0.5] = rng.choice(pool, int((u < 0.5).sum()))
    if subnormals:
        sub = (u >= 0.5) & (u < 0.52)
        acc[sub] = (rng.integers(1, 100, int(sub.sum())) * np.float32(1e-45)).astype(np.float32)
    counts = rng.integers(1, 5, (count_rows, g))
    counts[rng.random((count_rows, g)) < 0.2] = 0
    acc[:count_rows] = counts
    return acc


def topk_classes_acc(np, rng, g: int, sizes: tuple[int, int, int]):
    """An accumulator f32 [3, g] (count, pac, value rows) whose hazard
    classes are small, so that a k of at most TOPK_BLOCK_MAX_K can cut inside
    each: `sizes` = (real keys, NaN keys, NULL aggregates) at random slots,
    the real values small integers (ties), every other slot empty. Returns
    it and the k that cuts halfway into the NaN and the NULL class, and as
    far into the empty slots as into the NULL class."""
    n_real, n_nan, n_null = sizes
    acc = np.zeros((3, g), np.float32)
    slots = rng.permutation(g)
    real, nan = slots[:n_real], slots[n_real:n_real + n_nan]
    null = slots[n_real + n_nan:n_real + n_nan + n_null]
    live = np.concatenate([real, nan])
    acc[0, live] = acc[1, live] = rng.integers(1, 5, live.size)
    acc[2, real] = rng.integers(0, 5, n_real)
    acc[2, nan] = np.nan
    acc[0, null] = rng.integers(1, 5, n_null)
    cuts = (n_real + n_nan // 2, n_real + n_nan + n_null // 2,
            n_real + n_nan + n_null + n_null // 2)
    return acc, cuts


class K3Recorder:
    """Records each query's first K3 calls (its block shape, inputs cloned)
    while the real wrappers run; `query` names the query being driven."""

    def __init__(self, F):
        self.F = F
        self.query = None
        self.shapes: dict[str, dict] = {k: {} for k in K3_KERNELS}
        self.inputs: dict[str, dict] = {k: {} for k in K3_KERNELS}
        self.real = {k: getattr(F, k) for k in K3_KERNELS}

    def _record(self, name, data):
        key = self.query
        self.shapes[name][key] = self.shapes[name].get(key, 0) + 1
        if key not in self.inputs[name]:
            self.inputs[name][key] = clone_args(data)

    def __enter__(self):
        def mask_ids(words, slots, n, *, with_ids=True):
            self._record("mask_ids", (words, slots, n, with_ids))
            return self.real["mask_ids"](words, slots, n, with_ids=with_ids)

        def stack_operands(words, slots, mask, nf, nb):
            self._record("stack_operands", (words, slots, mask, nf, nb))
            return self.real["stack_operands"](words, slots, mask, nf, nb)

        self.F.mask_ids, self.F.stack_operands = mask_ids, stack_operands
        return self

    def __exit__(self, *exc):
        self.F.mask_ids, self.F.stack_operands = (self.real[k] for k in K3_KERNELS)


# ------------------------------------------------------------------- lake


def make_minute(pa, np, rng, minute: int, n: int):
    """One minute of bench.py's "default" access-log profile (the same
    columns, value sets and draw order), built with numpy."""
    hosts = [f"10.0.{i}.{j}" for i in range(4) for j in range(8)]
    paths = [f"/api/v1/resource{i}" for i in range(64)]
    messages = (
        [f"request completed in {d}ms" for d in range(0, 400, 25)]
        + [f"error: upstream timeout after {d}ms" for d in range(0, 400, 50)]
        + [f"slow query warning threshold {d}" for d in range(0, 200, 25)]
        + ["connection reset by peer", "error: permission denied", "cache miss"]
    )
    statuses = np.array([200, 200, 200, 200, 301, 404, 500, 503], dtype=np.float64)
    methods = ["GET", "GET", "GET", "POST", "PUT", "DELETE"]

    def strings(values, idx):
        return pa.DictionaryArray.from_arrays(
            pa.array(idx.astype(np.int32)), pa.array(values)
        ).cast(pa.string())

    offsets = np.sort(rng.integers(0, 60_000, n))
    start = np.datetime64(BASE.replace(tzinfo=None), "ms") + np.timedelta64(minute, "m")
    message = strings(messages, rng.integers(0, len(messages), n))
    return pa.table(
        {
            "p_timestamp": pa.array(start + offsets.astype("timedelta64[ms]"), pa.timestamp("ms")),
            "host": strings(hosts, rng.integers(0, len(hosts), n)),
            "method": strings(methods, rng.integers(0, len(methods), n)),
            "path": strings(paths, rng.integers(0, len(paths), n)),
            "message": message,
            "status": pa.array(statuses[rng.integers(0, len(statuses), n)]),
            "bytes": pa.array(rng.integers(100, 50_000, n).astype(np.float64)),
            "latency_ms": pa.array(rng.random(n) * 500),
        }
    )


def rows_of(table) -> list[tuple]:
    """Result rows sorted on their group keys (str columns and timestamps)."""
    key_cols = [c for c in table.column_names if c in ("t", "status", "path", "host")]
    rows = table.to_pylist()
    return sorted(rows, key=lambda r: tuple(str(r[c]) for c in key_cols))


def same_result(name: str, gpu, cpu, rel: dict | None = None) -> None:
    """Rows equal on their keys; floats within ABS_TOL + REL_TOL (or the
    column's own relative tolerance in `rel`) of the CPU engine's."""
    a, b = rows_of(gpu), rows_of(cpu)
    check(len(a) == len(b), f"{name}: {len(a)} rows on gpu vs {len(b)} on cpu")
    for ra, rb in zip(a, b):
        check(ra.keys() == rb.keys(), f"{name}: columns differ")
        for col in ra:
            va, vb = ra[col], rb[col]
            if isinstance(va, float) and isinstance(vb, float):
                tol = (rel or {}).get(col, REL_TOL)
                check(
                    abs(va - vb) <= ABS_TOL + tol * abs(vb),
                    f"{name}.{col}: gpu {va} vs cpu {vb}",
                )
            else:
                check(va == vb, f"{name}.{col}: gpu {va!r} vs cpu {vb!r}")


def same_select(name: str, gpu, cpu, order_key: str | None) -> None:
    """A select's rows equal the CPU engine's: as multisets, and in order on
    `order_key` where the query orders. Rows tied on the order key at the
    LIMIT's edge may be any of the tied rows (the scan yields blocks in
    completion order), so there only their number must agree."""
    import pyarrow.compute as pc

    def by_all(t):
        return t.sort_by([(c, "ascending") for c in t.column_names])

    check(gpu.column_names == cpu.column_names, f"{name}: columns {gpu.column_names}")
    check(gpu.num_rows == cpu.num_rows, f"{name}: {gpu.num_rows} rows on gpu vs {cpu.num_rows}")
    if order_key is None or gpu.num_rows == 0:
        check(by_all(gpu).equals(by_all(cpu)), f"{name}: rows differ")
        return
    keys = gpu[order_key].to_pylist()
    check(keys == cpu[order_key].to_pylist(), f"{name}: {order_key} order differs")
    edge = gpu[order_key][gpu.num_rows - 1]
    inner_g = gpu.filter(pc.not_equal(gpu[order_key], edge))
    inner_c = cpu.filter(pc.not_equal(cpu[order_key], edge))
    check(by_all(inner_g).equals(by_all(inner_c)), f"{name}: rows above the edge differ")


def build_lake(work: Path, seed: int, minutes: int, rows: int, stream_name: str = STREAM,
               make=None, phase: str = "phase 3"):
    """Phase 3 (10): stage one Parquet file per minute (`make`, by default
    `make_minute`) and sync it into the lake through the port's own upload
    and catalog commit."""
    import numpy as np
    import pyarrow as pa

    from parseable_tpu_torch.config import Options, StorageOptions
    from parseable_tpu_torch.core import Parseable

    t0 = time.perf_counter()
    opts = Options()
    opts.local_staging_path = work / "staging"
    # the engine phases measure the engine in each cache state, not the
    # result cache (phase 11 turns it on)
    opts.query_result_cache_bytes = 0
    p = Parseable(opts, StorageOptions(root=work / "data"))
    stream = p.create_stream_if_not_exists(stream_name)
    rng = np.random.default_rng(seed)
    for minute in range(minutes):
        table = (make or make_minute)(pa, np, rng, minute, rows)
        stream.write_parquet(table, BASE + timedelta(minutes=minute))
    t1 = time.perf_counter()
    p.sync_all_streams()  # uploads, commits, and seeds the encoded-block cache
    fmt = p.metastore.get_stream_json(stream_name)
    check(fmt.stats.events == minutes * rows, f"lake holds {fmt.stats.events} rows")
    check(not stream.parquet_files(), "staged parquet left after sync")
    seeded = sorted((work / "staging" / "encoded_cache").glob("*.enc"))
    check(len(seeded) == minutes, f"the upload seed wrote {len(seeded)} of {minutes} entries")
    log(
        f"{phase} lake: {fmt.stats.events} rows in {minutes} files, "
        f"{fmt.stats.storage} parquet bytes, {time.perf_counter() - t0:.2f} s (sync and the "
        f"encoded-block cache seed {time.perf_counter() - t1:.2f} s, "
        f"{sum(f.stat().st_size for f in seeded)} bytes in {len(seeded)} entries)"
    )
    return p


# device kernel names of each hand kernel, as the profiler reports them
KERNEL_SYMBOLS = {
    "additive_groupby": "additive", "minmax_groupby": "minmax",
    "distinct_fold": "distinct_", "pct_histogram": "pct_hist_",
    "centered_m2": "m2_", "mask_ids": "k3_mask_ids", "stack_operands": "k3_stack_operands",
    "topk_groups": "k8_", "mesh_combine": "mesh_combine",
}


def device_breakdown(prof) -> dict:
    """torch.profiler's device busy time of one query, in us, split into
    host -> device copies, device -> host copies, each hand kernel, and
    every other device op (kernels and memsets), the three largest named."""
    out = {"busy": 0.0, "h2d": 0.0, "d2h": 0.0, "hand": 0.0, "other": 0.0}
    hand = dict.fromkeys(KERNEL_SYMBOLS, 0.0)
    calls = dict.fromkeys(KERNEL_SYMBOLS, 0)
    others: dict[str, float] = {}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        out["busy"] += us
        kernel = next((k for k, sym in KERNEL_SYMBOLS.items() if sym in ev.key), None)
        if "HtoD" in ev.key:
            out["h2d"] += us
        elif "DtoH" in ev.key:
            out["d2h"] += us
        elif kernel is not None:
            out["hand"] += us
            hand[kernel] += us
            calls[kernel] += ev.count
        else:
            out["other"] += us
            others[ev.key] = others.get(ev.key, 0.0) + us
    out["hand_kernels"] = {k: [round(hand[k], 3), calls[k]] for k in KERNEL_SYMBOLS if calls[k]}
    out["top_other"] = [[k[:90], round(v, 3)] for k, v in
                        sorted(others.items(), key=lambda kv: -kv[1])[:3]]
    return out


# each profiled query that called K8: its K8 kernels (the profiler's count)
# and its K8 calls (the wrapper's), {"query", "kernels", "calls"}
K8_PROFILED: list[dict] = []


def profiled_query(torch, sess, qname: str, text: str, phase: str, state: str):
    """One more GPU run under torch.profiler: the device's busy time
    (kernels and copies) against the query's wall time, and its breakdown
    (`device_breakdown`)."""
    from torch.profiler import ProfilerActivity, profile

    from parseable_tpu_torch.ops import topk_cuda as K

    before = K.LAUNCHES["topk_groups"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = sess.query(text)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    b = device_breakdown(prof)
    if K.LAUNCHES["topk_groups"] > before:
        K8_PROFILED.append({"query": f"{phase} {qname} {state}",
                            "kernels": b["hand_kernels"].get("topk_groups", [0.0, 0])[1],
                            "calls": K.LAUNCHES["topk_groups"] - before})
    if b["busy"] == 0.0:
        log(f"{phase} {qname} {state} profile: the profiler saw no device time (not measured)")
    else:
        log(
            f"{phase} {qname} {state} profile: wall {wall_ms:.3f} ms, device busy "
            f"{b['busy'] / 1e3:.3f} ms (idle share {1 - b['busy'] / 1e3 / wall_ms:.4f}); "
            f"breakdown us: h2d {b['h2d']:.3f}, d2h {b['d2h']:.3f}, hand kernels "
            f"{b['hand']:.3f} {json.dumps(b['hand_kernels'])}, other {b['other']:.3f}, "
            f"largest other {json.dumps(b['top_other'])}"
        )
    return res


# cache states of a lake query (PERF.md §2): cold = hot set and encoded-block
# cache empty; page-cache warm = no encoded-block cache, hot set cleared (a
# warm page cache only: Parquet read and encode again); disk-warm = hot set
# cleared, the encoded-block cache serves; device-warm = the hot set serves
STATES = ("cold", "page-cache warm", "disk-warm", "device-warm")


def state_runs(torch, p, qname: str, text: str, phase: str, device, rel=None,
               select: tuple | None = None, states: tuple = STATES, compare=None) -> list:
    """One lake query on the "gpu" engine in the cache `states` (all four by
    default), one more profiled page-cache-warm and device-warm run each
    (on the card), then once on the "cpu" engine. Every GPU run equals the
    CPU run, stays on the device, and resolves its blocks as its state says.
    A select (`select` = (its order column or None,)) reads Parquet in
    every state, for its projection, and its answer is held by
    `same_select`; `compare(name, gpu, cpu)`, when given, holds the answers
    instead of `same_result`. Returns the GPU results."""
    import os

    from parseable_tpu_torch.ops.enccache import get_enccache
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.session import QuerySession

    on_card = device is None or torch.device(device).type == "cuda"
    cache = get_enccache(p.options)

    def gpu(state: str, profiled: bool = False):
        hs = get_hotset()
        if state == "cold":
            hs.clear()
            cache.wait_idle()
            for f in cache.root.glob("*.enc"):
                f.unlink()
        elif state == "page-cache warm":
            hs.clear()
            os.environ["P_TPU_ENC_CACHE"] = "0"
        elif state == "disk-warm":
            cache.wait_idle()
            hs.clear()
        try:
            sess = QuerySession(p, engine="gpu", device=device)
            if profiled:
                return profiled_query(torch, sess, qname, text, phase, state)
            t = time.perf_counter()
            res = sess.query(text)
            if on_card:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t
        finally:
            os.environ.pop("P_TPU_ENC_CACHE", None)
        st, r = res.stats, res.stats["device_routes"]
        stages = {k: v for k, v in st["stages"].items() if k != "hotset"}
        log(
            f"{phase} {qname} gpu {state}: {res.table.num_rows} rows out, {st['rows_scanned']} "
            f"scanned in {dt:.3f} s = {st['rows_scanned'] / dt:.6g} rows/s, wall {dt * 1e3:.3f} ms, "
            f"{st['bytes_scanned']} Parquet bytes read, h2d block bytes "
            f"{r['h2d_bytes'] - r['h2d_aux_bytes']} aux bytes {r['h2d_aux_bytes']}, stages "
            f"{stages} routes {r} hotset {st['stages']['hotset']}"
        )
        return res

    out = []
    for state in states:
        res = gpu(state)
        if on_card and state in ("page-cache warm", "device-warm"):
            out.append(gpu(state, profiled=True))
        out.append(res)
        st, r = res.stats, res.stats["device_routes"]
        blocks = st["files_total"] - st["files_pruned"]
        check(blocks > 0, f"{qname}: no lake block scanned")
        if state == "device-warm":
            check((r["device_warm"], r["device_cold"]) == (blocks, 0),
                  f"{qname} {state}: {blocks} blocks but routes {r}")
            check(r["h2d_bytes"] == r["h2d_aux_bytes"], f"{qname} {state}: block bytes shipped {r}")
        elif state == "disk-warm":
            check(r["device_warm"] + r["device_cold"] == blocks
                  and r["device_warm"] == r.get("prefetch_hits", 0),
                  f"{qname} {state}: {blocks} blocks but routes {r}")
        else:
            check((r["device_warm"], r["device_cold"]) == (0, blocks),
                  f"{qname} {state}: {blocks} blocks but routes {r}")
        check((st["bytes_scanned"] > 0) == (select is not None or state in ("cold", "page-cache warm")),
              f"{qname} {state}: {st['bytes_scanned']} Parquet bytes read")
        check(r.get("prefetch_errors", 0) == 0, f"{qname} {state}: prefetch errors {r}")
    t = time.perf_counter()
    cpu = QuerySession(p, engine="cpu").query(text)
    dt = time.perf_counter() - t
    log(f"{phase} {qname} cpu: {cpu.table.num_rows} rows out, {cpu.stats['rows_scanned']} "
        f"scanned in {dt:.3f} s = {cpu.stats['rows_scanned'] / dt:.6g} rows/s, "
        f"stages {cpu.stats['stages']}")
    from parseable_tpu_torch.parallel.mesh import pinned_mesh

    for res in out:
        routes = res.stats["device_routes"]
        check(routes["cpu_fallback"] == 0, f"{qname}: cpu_fallback {routes}")
        # no P_TPU_MESH on one card: no mesh forms (phase 12 pins its own)
        check(pinned_mesh() is not None or routes["device_mesh"] == 0,
              f"{qname}: a mesh formed unasked {routes}")
        # the card's measured link and host rates keep every block on it
        check(routes["cpu_adaptive"] == 0, f"{qname}: cpu_adaptive {routes}")
        check(res.stats["scan_errors"] == 0, f"{qname}: scan errors")
        if compare is not None:
            compare(qname, res.table, cpu.table)
        elif select is None:
            same_result(qname, res.table, cpu.table, rel)
        else:
            same_select(qname, res.table, cpu.table, select[0])
    check(out[0].table.num_rows > 0, f"{qname}: empty result")
    return out


def log_residency(torch, phase: str, on_card: bool) -> None:
    """The hot set after a phase, and the card's allocated memory."""
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.ops.link import get_link

    snap = get_hotset().stats_snapshot()
    mem = torch.cuda.memory_allocated() if on_card else "not measured"
    log(f"{phase} hot set {json.dumps(snap)}, torch.cuda.memory_allocated {mem}, "
        f"link profile {json.dumps(get_link().snapshot())}")


def drive_main_path(p, device=None) -> tuple[dict, dict, dict, "K3Recorder", tuple]:
    """Phase 4: every query on the "gpu" engine (on `device`, default the
    card) and the "cpu" engine, cold then warm; the engines must agree, the
    GPU runs must stay on the device and launch the kernels: the aggregates
    K3a, K3b and A (B for minmax), the selects K3a alone. Returns the launch
    counts of the run, kernels A and B's shapes with their call counts, one
    block's inputs per shape (cloned), each query's K3 calls, and K8's first
    call (topk_multicol's; its accumulator cloned)."""
    import torch

    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops import groupby_cuda as G
    from parseable_tpu_torch.ops import topk_cuda as K

    shapes: dict[str, dict] = {"additive_groupby": {}, "minmax_groupby": {}}
    inputs: dict[str, dict] = {"additive_groupby": {}, "minmax_groupby": {}}
    real_a, real_b = G.additive_groupby, G.minmax_groupby
    real_topk = K.topk_groups
    topk_call: list[tuple] = []

    def rec_topk(acc, *args):
        if not topk_call:
            topk_call.append((acc.clone(), *args))
        return real_topk(acc, *args)

    def record(name, key, tensors):
        shapes[name][key] = shapes[name].get(key, 0) + 1
        if key not in inputs[name]:
            inputs[name][key] = tuple(t.clone() for t in tensors)

    def rec_a(ids, rows, g):
        record("additive_groupby", (rows.shape[0], rows.shape[1], g), (ids, rows))
        return real_a(ids, rows, g)

    def rec_b(ids, vals, valid, mask, g, n_min):
        record("minmax_groupby", (vals.shape[0], n_min, vals.shape[1], g), (ids, vals, valid, mask))
        return real_b(ids, vals, valid, mask, g, n_min)

    on_card = device is None or torch.device(device).type == "cuda"
    counts = kernel_counters()
    reset_launches(counts)
    G.additive_groupby, G.minmax_groupby, K.topk_groups = rec_a, rec_b, rec_topk
    try:
        with K3Recorder(F) as k3:
            runs = [(q, sql, None) for q, sql in QUERIES.items()]
            runs += [(q, sql, (key,)) for q, (sql, key) in SELECT_QUERIES.items()]
            for qname, sql, select in runs:
                k3.query = qname
                before = launch_counts(counts)
                state_runs(torch, p, qname, sql.format(stream=STREAM), "phase 4", device,
                           select=select)
                delta = {k: v - before[k] for k, v in launch_counts(counts).items()}
                if on_card:
                    check(delta["mask_ids"] > 0, f"{qname}: K3a never launched")
                    if select is None:
                        check(delta["stack_operands"] > 0, f"{qname}: K3b never launched")
                        check(delta["additive_groupby"] > 0, f"{qname}: kernel A never launched")
                    else:
                        check(delta["stack_operands"] == delta["additive_groupby"] == 0,
                              f"{qname}: a select launched the fold {delta}")
                    if qname == "minmax":
                        check(delta["minmax_groupby"] > 0, f"{qname}: kernel B never launched")
                    # ORDER BY <aggregate> LIMIT over 8,192 groups: the device top-k
                    check((delta["topk_groups"] > 0) == (qname == "topk_multicol"),
                          f"{qname}: K8 launches {delta['topk_groups']}")
                log(f"phase 4 {qname}: gpu == cpu in every cache state, launches {delta}")
    finally:
        G.additive_groupby, G.minmax_groupby, K.topk_groups = real_a, real_b, real_topk
    launches = launch_counts(counts)
    if on_card:
        for name in (*G.LAUNCHES, *F.LAUNCHES, *K.LAUNCHES):
            check(launches[name] > 0, f"{name} was never launched on the main path")
    log(f"phase 4 launches on the main path: {launches}")
    log_residency(torch, "phase 4", on_card)
    return launches, shapes, inputs, k3, topk_call[0] if topk_call else None


def drive_list3(device=None) -> int:
    """Phase 9: ROADMAP list 3's repros (`LIST3`) on the "gpu" engine (on
    `device`, default the card) and the "cpu" engine: the same rows, and
    every GPU block folded on the device. Returns the queries run."""
    import os

    import pyarrow as pa

    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.executor import QueryExecutor
    from parseable_tpu_torch.query.executor_cuda import SOURCE_ID_META, GpuQueryExecutor
    from parseable_tpu_torch.query.planner import TimeBounds, plan
    from parseable_tpu_torch.query.sql import parse_sql
    from parseable_tpu_torch.utils.timeutil import parse_rfc3339

    table = list3_table(pa)
    block = table.replace_schema_metadata({SOURCE_ID_META: b"list3"})
    os.environ["P_TPU_ENC_CACHE"] = "0"
    runs = 0
    try:
        for item, case, where, api_range in LIST3:
            for sql in list3_queries(where):
                answers = []
                for engine in ("gpu", "cpu"):
                    lp = plan(parse_sql(sql))
                    if api_range:
                        low, high = map(parse_rfc3339, api_range)
                        lp.time_bounds = lp.time_bounds.intersect(TimeBounds(low, high))
                    if engine == "gpu":
                        get_hotset().clear()
                        ex = GpuQueryExecutor(lp, device=device)
                        out = ex.execute(iter([block]))
                        r = ex.route_stats
                        # (a select without a WHERE never touches the card)
                        on_device = int(where is not None or "GROUP BY" in sql)
                        check(r["cpu_fallback"] == 0 and r["device_cold"] == on_device,
                              f"list 3 {item} {case}: routes {r}")
                    else:
                        out = QueryExecutor(lp).execute(iter([table]))
                    answers.append(list3_rows(out.to_pylist()))
                check(answers[0] == answers[1],
                      f"list 3 {item} {case}: gpu {answers[0]} vs cpu {answers[1]} ({sql})")
                runs += 1
    finally:
        os.environ.pop("P_TPU_ENC_CACHE", None)
        get_hotset().clear()
    log(f"phase 9 list 3: {len(LIST3)} repros, {runs} queries, gpu == cpu, cpu_fallback 0")
    return runs


def kernel_counters() -> tuple:
    """Every kernel wrapper's launch counter. Each phase resets and reads
    all of them, so every count it reports was measured in its own run."""
    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops import groupby_cuda as G
    from parseable_tpu_torch.ops import mesh_cuda as MC
    from parseable_tpu_torch.ops import stats_cuda as SC
    from parseable_tpu_torch.ops import topk_cuda as K

    return G.LAUNCHES, F.LAUNCHES, SC.LAUNCHES, K.LAUNCHES, MC.LAUNCHES


def launch_counts(counts: tuple) -> dict:
    """The kernels' launch counters, merged."""
    return {k: v for c in counts for k, v in c.items()}


def reset_launches(counts: tuple) -> None:
    for c in counts:
        for name in c:
            c[name] = 0


def drive_pressure(torch, p, device=None) -> dict:
    """Phase 8: a hot-set budget (P_TPU_HOT_BYTES) below the groupby query's
    resident bytes, so that blocks are evicted and the prefetcher ships the
    next block from the encoded-block cache (on its own CUDA stream on the
    card) while one aggregates. The query runs twice; both answers equal
    the CPU engine's. Returns the launch counts of the phase."""
    import os

    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.session import QuerySession

    on_card = device is None or torch.device(device).type == "cuda"
    text = QUERIES["groupby"].format(stream=STREAM)
    cpu = QuerySession(p, engine="cpu").query(text)
    QuerySession(p, engine="gpu", device=device).query(text)  # every block resident
    hs = get_hotset()
    blocks = sorted(slot.entry.nbytes for slot in hs._entries.values())
    resident = hs.resident_bytes
    budget = int(2.5 * blocks[-1])
    check(budget < resident, f"budget {budget} not below the resident {resident} bytes")
    counts = kernel_counters()
    reset_launches(counts)
    os.environ["P_TPU_HOT_BYTES"] = str(budget)
    try:
        runs = []
        for run in ("first", "second"):
            t = time.perf_counter()
            res = QuerySession(p, engine="gpu", device=device).query(text)
            if on_card:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t
            same_result(f"pressure {run}", res.table, cpu.table)
            r, hot = res.stats["device_routes"], res.stats["stages"]["hotset"]
            check(r["cpu_fallback"] == 0 and r["cpu_adaptive"] == 0,
                  f"pressure {run}: a block off the card {r}")
            log(f"phase 8 groupby {run} (hot-set budget {budget} of {resident} resident bytes): "
                f"wall {dt * 1e3:.3f} ms, stages "
                f"{ {k: v for k, v in res.stats['stages'].items() if k != 'hotset'} } "
                f"routes {r} hotset {hot}")
            runs.append(hot)
    finally:
        os.environ.pop("P_TPU_HOT_BYTES", None)
    get_hotset()  # re-rooted at the default budget
    check(runs[-1]["evictions"] > 0, f"pressure: no eviction {runs}")
    check(sum(h["prefetch_hits"] for h in runs) > 0, f"pressure: no prefetch hit {runs}")
    check(all(h["prefetch_errors"] == 0 for h in runs), f"pressure: prefetch errors {runs}")
    launches = launch_counts(counts)
    if on_card:
        check(launches["additive_groupby"] > 0 and launches["mask_ids"] > 0
              and launches["stack_operands"] > 0, f"pressure: a kernel never launched {launches}")
    log(f"phase 8 launches: {launches}")
    return launches


# ------------------------------------------------------------ statistics

STATS_QUERIES = {
    # G of about 8 (five status values): the shared histogram regime
    "stats_status": (
        "SELECT status, count(*) AS c, stddev(latency_ms) AS sd, var(bytes) AS vb, "
        "approx_percentile_cont(latency_ms, 0.99) AS p99, approx_median(bytes) AS p50 "
        "FROM {stream} WHERE p_timestamp >= '2024-05-01T00:02:00Z' GROUP BY status"
    ),
    # G of about 64 (minute bins x statuses): the global histogram regime and
    # an HLL register file of G x 4096 registers
    "stats_minute": (
        "SELECT date_bin(interval '1 minute', p_timestamp) AS t, status, "
        "count(distinct path) AS paths, approx_distinct(host) AS hosts, "
        "approx_percentile_cont(latency_ms, 0.5) AS p50 FROM {stream} "
        "WHERE status >= 400 GROUP BY t, status"
    ),
}
# against the CPU engine: stddev/var f32 moments rel 2e-4; percentiles the
# JAX package's own bound between its engines (tests/test_device_stats.py);
# counts, count(distinct) and approx_distinct (the same registers) exact
STATS_REL = {"sd": REL_TOL, "vb": REL_TOL, "p99": 0.06, "p50": 0.06}
STATS_KERNELS = ("distinct_fold", "pct_histogram", "centered_m2")


def stats_inputs(torch, SC, kind: str, key: tuple, gen) -> tuple:
    """Uniform inputs of one statistics kernel at `key`, as the main path
    shapes them: K5 (G, cap, hll, N) with int8 codes over a 100-value
    dictionary; K6 (G, N) with values uniform on [0, 500); K7 (Q, N, G)."""
    if kind == "distinct_fold":
        g, cap, hll, n = key
        v = 100
        lut = (torch.stack([torch.randint(0, cap, (v,), generator=gen),
                            torch.randint(1, 20, (v,), generator=gen)]) if hll
               else torch.randint(0, min(v, cap - 1), (v,), generator=gen))
        return (torch.zeros(g * cap), torch.randint(0, g, (n,), generator=gen, dtype=torch.int32),
                torch.randint(0, v, (n,), generator=gen).to(torch.int8),
                torch.rand(n, generator=gen) < 0.9, lut.to(torch.int32))
    if kind == "pct_histogram":
        g, n = key
        return (torch.zeros(g * SC.DEVICE_NB), torch.rand(n, generator=gen) * 500,
                torch.randint(0, g, (n,), generator=gen, dtype=torch.int32),
                torch.rand(n, generator=gen) < 0.9)
    q, n, g = key
    return (torch.randint(0, g, (n,), generator=gen, dtype=torch.int32),
            torch.rand(q, n, generator=gen) * 50_000, torch.rand(q, n, generator=gen) < 0.9,
            torch.rand(n, generator=gen) < 0.9, torch.rand(q, g, generator=gen) * 50_000)


def pct_edge_rows(torch, SC, vals, mask) -> int:
    """Live rows whose f32 log2|v| lies within one ulp of a bin edge (the
    rows a different log2 could move into a neighbouring bin)."""
    mag = torch.log2(vals.abs())
    up = SC.pct_bins(torch.nextafter(mag, torch.full_like(mag, math.inf)))
    down = SC.pct_bins(torch.nextafter(mag, torch.full_like(mag, -math.inf)))
    return int((mask & (vals != 0) & ~torch.isnan(vals) & (up != down)).sum())


def whole_copy_regime(SC, kind: str, key: tuple) -> str:
    """The rule before the compact regime: "shared", a private copy of
    the whole accumulator (K7: of the [Q, G] sums and means) a CTA, where it
    fits, else "global". The compact regime is timed against it."""
    if kind == "distinct_fold":
        return "shared" if key[0] * key[1] <= SC.DISTINCT_SHARED_MAX else "global"
    if kind == "centered_m2":
        return "shared" if 2 * key[0] * key[2] * 4 <= SC.SMEM_BUDGET else "global"
    return "shared" if key[0] * SC.DEVICE_NB * 4 <= SC.SMEM_BUDGET else "global"


def rule_regime(SC, kind: str, key: tuple) -> str:
    """The regime the wrapper's rule picks at `key` (as in `stats_inputs`)."""
    if kind == "distinct_fold":
        return SC.distinct_regime(*key[:3])
    if kind == "centered_m2":
        return SC.m2_regime(key[0], key[2])
    return SC.pct_regime(key[0])


def m2_close(torch, got, want) -> bool:
    """K7 against its f64 plain version: NaN and +-inf in the same cells,
    the finite cells within rel 2e-4."""
    fin = torch.isfinite(want)
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want))
            and bool(torch.allclose(got[fin], want[fin], rtol=REL_TOL, atol=ABS_TOL)))


def m2_poisoned(torch, ids, vals, valid, mask, g: int):
    """The K7 inputs with a NaN in one live row and +inf in a live row of
    another group (value row Q - 1): each must poison its own group only."""
    live = mask & valid[-1] & (ids >= 0) & (ids < g)
    rows = torch.nonzero(live).flatten()
    first = int(rows[0])
    other = rows[ids[rows] != ids[first]]
    vals = vals.clone()
    vals[-1, first] = math.nan
    if other.numel():
        vals[-1, int(other[0])] = math.inf
    return vals


_SUM_MS: dict[int, float] = {}


def stream_sum_ms(torch, timer, nbytes: float) -> float:
    """A yardstick: one torch.sum over float32 data of `nbytes` (the card's
    reduction reading as many bytes once), L2-cold."""
    key = int(nbytes)
    if key not in _SUM_MS:
        copies = n_copies(nbytes)
        xs = [torch.rand(max(1, key // 4), device="cuda") for _ in range(copies)]
        _SUM_MS[key] = timer.ms(lambda k: torch.sum(xs[k]), copies)
    return _SUM_MS[key]


def stats_case(torch, SC, timer, kind: str, key: tuple, data: tuple, inputs: str,
               regime: str | None = None, turns: tuple[str, ...] = ()) -> dict:
    """One statistics kernel at `key` (as in `stats_inputs`) against its
    plain version on the card (K5 and K6 bit for bit, K7 within rel 2e-4 of
    its f64 plain version), then timed L2-cold and L2-warm beside its plain
    version and one library call on the same inputs, with its bound: the
    block's inputs read once, plus the accumulator entries its rows reach
    (K5, K6) or K7's means and output, and one torch.sum over as many bytes
    (`sum_ms`). K7 also on a copy of its inputs with a NaN and an inf value
    (each in its own group only). Optionally also: each regime of `turns`
    checked (K5 and K6 bit for bit) and timed L2-cold in that order
    (`turns_us`)."""
    data = tuple(t.cuda().contiguous() for t in data)
    res = {"shape": f"{kind} {key}", "inputs": inputs}
    if kind == "distinct_fold":
        g, cap, hll, n = key
        acc, ids, codes, mask, lut = data
        res["regime"] = regime or SC.distinct_regime(g, cap, hll)
        got = SC.distinct_fold(acc.clone(), ids, codes, mask, cap, lut, regime=res["regime"])
        want = SC.distinct_fold_plain(acc, ids, codes, mask, cap, lut)
        check(torch.equal(got, want), f"K5 not exact: {res['shape']}")
        reached = SC.distinct_fold_plain(torch.zeros_like(acc), ids, codes, mask, cap, lut)
        nbytes = n * (4 + codes.element_size() + 1) + lut.numel() * 4
        ops = n
    elif kind == "pct_histogram":
        g, n = key
        acc, vals, ids, mask = data
        res["regime"] = regime or SC.pct_regime(g)
        got = SC.pct_histogram(acc.clone(), vals, ids, mask, regime=res["regime"])
        want = SC.pct_histogram_plain(acc, vals, ids, mask)
        res["edge_rows"] = pct_edge_rows(torch, SC, vals, mask)
        res["bins_differing"] = int((got != want).sum())
        check(res["bins_differing"] == 0, f"K6 not exact per bin: {res}")
        reached = SC.pct_histogram_plain(torch.zeros_like(acc), vals, ids, mask)
        nbytes = n * 9
        ops = 6 * n
    else:
        q, n, g = key
        ids, vals, valid, mask, mean = data
        res["regime"] = regime or SC.m2_regime(q, g)
        got = SC.centered_m2(ids, vals, valid, mask, mean, regime=res["regime"])
        want = SC.centered_m2_plain(ids, vals, valid, mask, mean)
        check(m2_close(torch, got, want), f"K7 disagrees with its f64 plain version: {res['shape']}")
        poisoned = m2_poisoned(torch, ids, vals, valid, mask, g)
        want_poisoned = SC.centered_m2_plain(ids, poisoned, valid, mask, mean)
        for reg in dict.fromkeys((res["regime"], *turns)):
            got_poisoned = SC.centered_m2(ids, poisoned, valid, mask, mean, regime=reg)
            check(m2_close(torch, got_poisoned, want_poisoned)
                  and int((~torch.isfinite(got_poisoned)).sum()) <= 2,
                  f"K7 {reg}: a NaN or inf reached another group: {res['shape']}")
        nbytes = n * (4 + 1 + 5 * q) + 2 * q * g * 4
        ops = 3 * q * n
    if kind != "centered_m2":
        # the accumulator entries this block's rows reach, read and written
        # once; the rest of the accumulator the fold need not touch
        res["entries_reached"] = int((reached > 0).sum())
        nbytes += 8 * res["entries_reached"]
    both = torch.isfinite(got) & torch.isfinite(want)
    res["max_abs_err"] = (got - want)[both].abs().max().item() if both.any() else 0.0
    copies = n_copies(nbytes)
    sets = [data] + [tuple(t.clone() for t in data) for _ in range(copies - 1)]
    reset = None
    if kind == "distinct_fold":
        # the library call gets the flat slots and values ready-made
        def flat_of(d):
            acc, ids, codes, mask, lut = d
            c = codes.long()
            slot = torch.clamp((lut[0] if hll else lut).long()[c], max=cap - 1)
            val = lut[1][c].float() if hll else torch.ones(n, device=c.device)
            return torch.where(mask, ids.long() * cap + slot, g * cap), torch.where(mask, val, 0.0)

        lib_in = [flat_of(d) for d in sets]
        # Every timed call folds into a fresh copy of the accumulator as this
        # block found it (with the library's spare slot): folded again into
        # registers that already hold their values, K5 would skip every
        # store and atomic, and time a no-op.
        pool = [torch.cat([acc, acc.new_zeros(1)]) for _ in range(3 + 2 * REPS)]
        turn = [0]

        def fresh():
            turn[0] += 1
            return pool[(turn[0] - 1) % len(pool)]

        def reset():
            for a in pool:
                a[:-1].copy_(acc)
            turn[0] = 0

        def call(reg):
            return lambda k: SC.distinct_fold(fresh()[:-1], *sets[k][1:4], cap, sets[k][4],
                                              regime=reg)

        fns = {
            "ms": call(res["regime"]),
            "plain_ms": lambda k: SC.distinct_fold_plain(*sets[k][:4], cap, sets[k][4]),
            "library_ms": lambda k: fresh().scatter_reduce_(0, *lib_in[k], "amax"),
        }
        res["library"] = "scatter_reduce_ amax"
    elif kind == "pct_histogram":
        def flat_of(d):
            acc, vals, ids, mask = d
            live = mask & ~torch.isnan(vals)
            return (torch.where(live, ids.long() * SC.DEVICE_NB + SC.pct_slots(vals), g * SC.DEVICE_NB),
                    live.float())

        lib_in = [flat_of(d) for d in sets]
        lib_acc = torch.zeros(g * SC.DEVICE_NB + 1, device="cuda")
        def call(reg):
            return lambda k: SC.pct_histogram(*sets[k], regime=reg)

        fns = {
            "ms": call(res["regime"]),
            "plain_ms": lambda k: SC.pct_histogram_plain(*sets[k]),
            "library_ms": lambda k: lib_acc.index_add_(0, *lib_in[k]),
        }
        res["library"] = "index_add_"
    else:
        def flat_of(d):
            ids, vals, valid, mask, mean = d
            d2 = torch.where(valid & mask[None], vals - mean[:, ids.long()], 0.0)
            return ids.long(), d2 * d2

        lib_in = [flat_of(d) for d in sets]
        lib_out = torch.zeros(q, g, device="cuda")

        def call(reg):
            return lambda k: SC.centered_m2(*sets[k], regime=reg)

        def library_full(k):
            # the same function from K7's own inputs: the mean's gather, the
            # mask, the square and index_add_, all in the timed window
            ids, vals, valid, mask, mean = sets[k]
            d = torch.where(valid & mask[None], vals - mean[:, ids], 0.0)
            return lib_out.index_add_(1, ids, d * d)

        fns = {
            "ms": call(res["regime"]),
            "plain_ms": lambda k: SC.centered_m2_plain(*sets[k]),
            "library_ms": lambda k: lib_out.index_add_(1, *lib_in[k]),
            "library_full_ms": library_full,
        }
        res["library"] = ("library_ms: index_add_ of the centred squares built before the "
                          "window; library_full_ms: the gather, mask, square and index_add_ in it")
    for reg in dict.fromkeys(turns):  # before K6's timed calls add into acc
        if kind == "distinct_fold":
            other = SC.distinct_fold(acc.clone(), ids, codes, mask, cap, lut, regime=reg)
        elif kind == "pct_histogram":
            other = SC.pct_histogram(acc.clone(), vals, ids, mask, regime=reg)
        else:
            other = SC.centered_m2(ids, vals, valid, mask, mean, regime=reg)
            check(m2_close(torch, other, want), f"K7 {reg} disagrees: {res['shape']}")
            continue
        check(torch.equal(other, want), f"{kind} {reg} not exact: {res['shape']}")
    res.update(timed(timer, fns, copies, reset))
    for reg in turns:
        if reset:
            reset()
        res.setdefault("turns_us", {}).setdefault(reg, []).append(timer.ms(call(reg), copies) * 1e3)
    if reset:
        reset()
    res["profiler_ms"], res["profiler_kernels"] = profiled_ms(
        torch, fns["ms"], (KERNEL_SYMBOLS[kind],))
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, ops)
    res["sum_ms"] = stream_sum_ms(torch, timer, nbytes)
    res["copies"] = copies
    return res


# phase 2: every regime of each statistics kernel on uniform inputs. Compact
# CTAs of 4,096-8,192 uniform rows touch every group at K5 G = 2048 and
# 64 x 4096 HLL and K6 G >= 128, more than their copy holds: those check the
# per-CTA fallback to global atomics.
STATS_REGIMES = (
    ("distinct_fold", (8, 128, False, N_BLOCK), "shared"),
    ("distinct_fold", (8, 128, False, N_BLOCK), "compact"),
    ("distinct_fold", (64, 128, False, N_BLOCK), "shared"),
    ("distinct_fold", (64, 128, False, N_BLOCK), "global"),
    ("distinct_fold", (64, 128, False, N_BLOCK), "compact"),
    ("distinct_fold", (2048, 128, False, N_BLOCK), "global"),
    ("distinct_fold", (2048, 128, False, N_BLOCK), "compact"),
    ("distinct_fold", (8, 4096, True, N_BLOCK), "shared"),
    ("distinct_fold", (8, 4096, True, N_BLOCK), "global"),
    ("distinct_fold", (8, 4096, True, N_BLOCK), "compact"),
    ("distinct_fold", (64, 4096, True, N_BLOCK), "global"),
    ("distinct_fold", (64, 4096, True, N_BLOCK), "compact"),
    ("pct_histogram", (8, N_BLOCK), "shared"),
    ("pct_histogram", (8, N_BLOCK), "global"),
    ("pct_histogram", (8, N_BLOCK), "compact"),
    ("pct_histogram", (128, N_BLOCK), "global"),
    ("pct_histogram", (128, N_BLOCK), "compact"),
    ("pct_histogram", (2048, N_BLOCK), "global"),
    ("pct_histogram", (2048, N_BLOCK), "compact"),
    # K7: compact timed in turns with "shared" where it holds the shape;
    # past 16 [Q, G] cells the two whole-copy regimes
    ("centered_m2", (2, N_BLOCK, 8), "compact"),
    ("centered_m2", (1, N_BLOCK, 8), "compact"),
    ("centered_m2", (2, N_BLOCK, 8), "shared"),
    ("centered_m2", (2, N_BLOCK, 8), "global"),
    ("centered_m2", (2, N_BLOCK, 64), "shared"),
    ("centered_m2", (2, N_BLOCK, 64), "global"),
    ("centered_m2", (2, N_BLOCK, 65536), "global"),
)


def drive_stats(p, device=None) -> tuple[dict, dict, dict, "K3Recorder"]:
    """Phase 7: the two dashboard queries on the "gpu" engine (on `device`,
    default the card) and the "cpu" engine, cold then warm, as in phase 4;
    every GPU run must stay on the device and launch K5-K7. Returns the
    launch counts of the phase (all kernels), the statistics kernels'
    shapes with their call counts, one block's inputs per shape, and each
    query's K3 calls."""
    import torch

    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops import groupby_cuda as G
    from parseable_tpu_torch.ops import stats_cuda as SC

    shapes: dict[str, dict] = {k: {} for k in STATS_KERNELS}
    inputs: dict[str, dict] = {k: {} for k in STATS_KERNELS}
    real = {k: getattr(SC, k) for k in STATS_KERNELS}

    def record(name, key, tensors):
        shapes[name][key] = shapes[name].get(key, 0) + 1
        if key not in inputs[name]:
            inputs[name][key] = tuple(t.clone() for t in tensors)

    def rec_k5(acc, ids, codes, mask, cap, lut=None, **kw):
        hll = lut is not None and lut.dim() == 2
        record("distinct_fold", (acc.numel() // cap, cap, hll, ids.shape[0]),
               (acc, ids, codes, mask, lut))
        return real["distinct_fold"](acc, ids, codes, mask, cap, lut, **kw)

    def rec_k6(acc, vals, ids, mask, **kw):
        record("pct_histogram", (acc.numel() // SC.DEVICE_NB, ids.shape[0]), (acc, vals, ids, mask))
        return real["pct_histogram"](acc, vals, ids, mask, **kw)

    def rec_k7(ids, vals, valid, mask, mean, **kw):
        record("centered_m2", (vals.shape[0], vals.shape[1], mean.shape[1]),
               (ids, vals, valid, mask, mean))
        return real["centered_m2"](ids, vals, valid, mask, mean, **kw)

    on_card = device is None or torch.device(device).type == "cuda"
    SC.distinct_fold, SC.pct_histogram, SC.centered_m2 = rec_k5, rec_k6, rec_k7
    counts = kernel_counters()
    reset_launches(counts)
    try:
        with K3Recorder(F) as k3:
            for qname, sql in STATS_QUERIES.items():
                k3.query = qname
                before = launch_counts(counts)
                out = state_runs(torch, p, qname, sql.format(stream=STREAM), "phase 7", device,
                                 STATS_REL)
                delta = {k: v - before[k] for k, v in launch_counts(counts).items()}
                log(f"phase 7 {qname}: gpu == cpu in every cache state, launches {delta}, first "
                    f"rows {json.dumps(rows_of(out[0].table)[:2], default=str)}")
    finally:
        SC.distinct_fold, SC.pct_histogram, SC.centered_m2 = (real[k] for k in STATS_KERNELS)
    launches = launch_counts(counts)
    if on_card:
        for name in (*G.LAUNCHES, *F.LAUNCHES, *SC.LAUNCHES):
            check(launches[name] > 0, f"{name} was never launched in phase 7")
    m2_regimes = {str(key): SC.m2_regime(key[0], key[2]) for key in shapes["centered_m2"]}
    check(set(m2_regimes.values()) == {"compact"}, f"K7 left the compact regime: {m2_regimes}")
    log(f"phase 7 launches: {launches}, K7 regimes {m2_regimes}")
    log_residency(torch, "phase 7", on_card)
    return launches, shapes, inputs, k3

# ---------------------------------------------------------- high cardinality

HC_STREAM = "hc"
HC_MINUTES = 8  # 2^23 rows in all, one 2^20-row file a minute
# (query, its group keys, the ORDER BY column of a LIMIT query or None)
HC_QUERIES = {
    # dense (2^17 path slots); ORDER BY <aggregate> LIMIT picks on the card (K8)
    "hc_topk_path": (
        "SELECT path, count(*) AS c, sum(bytes) AS s FROM {stream} "
        "GROUP BY path ORDER BY s DESC LIMIT 10",
        ("path",), "s",
    ),
    # 8 minute bins (the scan's time hint) x 2^17 path slots pass DENSE_G_MAX:
    # block-local from the first block on, K3a's KEY_CODE, A, B and K7 at
    # 8 x 2^17 groups a block; no LIMIT, so every group is compared
    "hc_minute_path": (
        "SELECT date_bin(interval '1 minute', p_timestamp) AS t, path, count(*) AS c, "
        "max(latency_ms) AS m, stddev(latency_ms) AS sd FROM {stream} GROUP BY t, path",
        ("t", "path"), None,
    ),
    # BASELINE config 4 on the highcard profile: 2^17 x 2^14 slots pass
    # LOCAL_G_MAX, so each block's pairs compact (pair mode, ~2^21 groups)
    "hc_topk_multicol": (
        "SELECT path, host, count(*) AS c, sum(bytes) AS s FROM {stream} "
        "GROUP BY path, host ORDER BY s DESC LIMIT 10",
        ("path", "host"), "s",
    ),
}
HC_LOCAL = ("hc_minute_path", "hc_topk_multicol")  # the queries that fold block-local
HC_STATES = ("cold", "disk-warm", "device-warm")


def make_hc_minute(pa, np, rng, minute: int, n: int):
    """One minute of bench.py's "highcard" profile (bench.py:76-83 and
    :109-124: the same columns, value sets and draw order), built with
    numpy and pyarrow: 10,240 hosts, 102,400 paths, and messages of four
    templates that carry a request id from a window of 50,000 fresh ids a
    minute."""
    import pyarrow.compute as pc

    hosts = [f"10.{i}.{j}.{k}" for i in range(10) for j in range(32) for k in range(32)]
    paths = [f"/api/v1/tenant{t}/resource{r}" for t in range(400) for r in range(256)]
    statuses = np.array([200, 200, 200, 200, 301, 404, 500, 503], dtype=np.float64)
    methods = ["GET", "GET", "GET", "POST", "PUT", "DELETE"]

    def strings(values, idx):
        return pa.DictionaryArray.from_arrays(
            pa.array(idx.astype(np.int32)), pa.array(values)
        ).cast(pa.string())

    offsets = np.sort(rng.integers(0, 60_000, n))
    req_ids = rng.integers(minute * 50_000, minute * 50_000 + 50_000, n)
    tmpl = rng.integers(0, 4, n)
    message = pc.binary_join_element_wise(
        strings(["request ", "error: upstream timeout for request ",
                 "slow query warning for request ", "request "], tmpl),
        pa.array(req_ids).cast(pa.string()),
        strings([" completed in 34ms", "", "", " cache miss"], tmpl),
        "",
    )
    start = np.datetime64(BASE.replace(tzinfo=None), "ms") + np.timedelta64(minute, "m")
    return pa.table(
        {
            "p_timestamp": pa.array(start + offsets.astype("timedelta64[ms]"), pa.timestamp("ms")),
            "host": strings(hosts, rng.integers(0, len(hosts), n)),
            "method": strings(methods, rng.integers(0, len(methods), n)),
            "path": strings(paths, rng.integers(0, len(paths), n)),
            "message": message,
            "status": pa.array(statuses[rng.integers(0, len(statuses), n)]),
            "bytes": pa.array(rng.integers(100, 50_000, n).astype(np.float64)),
            "latency_ms": pa.array(rng.random(n) * 500),
        }
    )


# The card reads latency_ms as f32: rounding a value moves its group's
# stddev by up to sqrt(n / (n - 1)) * 2^-24 * max|x| (Cauchy-Schwarz over the
# centred rounding errors), 4.2e-5 for latency_ms below 500, whatever the
# group's count. A group of two nearly equal values (sd ~ 0.02) is off by
# more than REL_TOL for that reason alone; the CPU engine reads f64.
HC_CAST_TOL = {"sd": 2**0.5 * 2.0**-24 * 500}


def same_table(name: str, gpu, cpu, keys: tuple) -> None:
    """Every group of a query without LIMIT, vectorized (10^5-10^6 rows):
    after sorting both answers on their keys, the keys and counts are
    equal, NULLs sit where the CPU engine's are, and floats are within
    ABS_TOL + REL_TOL of the CPU engine's (`same_result`'s tolerances),
    plus, for a column in HC_CAST_TOL, the bound of its f32 input rounding;
    the groups that need that term are counted in the log."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    check(gpu.num_rows == cpu.num_rows, f"{name}: {gpu.num_rows} rows on gpu vs {cpu.num_rows} on cpu")
    check(sorted(gpu.column_names) == sorted(cpu.column_names), f"{name}: columns differ")
    order = [(k, "ascending") for k in keys]
    a, b = gpu.sort_by(order), cpu.sort_by(order)
    for col in cpu.column_names:
        x, y = a[col], b[col]
        check(pc.all(pc.equal(pc.is_null(x), pc.is_null(y))).as_py(), f"{name}.{col}: NULLs differ")
        if col in keys or not pa.types.is_floating(y.type):
            check(pc.all(pc.equal(x.cast(y.type), y)).as_py() is not False,
                  f"{name}.{col}: values differ")
            continue
        xn = np.asarray(x.cast(pa.float64()).fill_null(0.0).to_numpy())
        yn = np.asarray(y.cast(pa.float64()).fill_null(0.0).to_numpy())
        err = np.abs(xn - yn)
        tol = ABS_TOL + REL_TOL * np.abs(yn)
        bad = err > tol + HC_CAST_TOL.get(col, 0.0)
        check(not bad.any(), f"{name}.{col}: {int(bad.sum())} values off, e.g. gpu "
              f"{xn[bad][:3].tolist()} vs cpu {yn[bad][:3].tolist()}")
        if col in HC_CAST_TOL:
            log(f"phase 10 {name}.{col}: {int((err > tol).sum())} of {len(err)} groups past "
                f"ABS_TOL + REL_TOL, all within the f32 input bound {HC_CAST_TOL[col]:.3g} "
                f"(largest error {err.max():.3g})")


def same_top(name: str, gpu, cpu, keys: tuple, order_col: str, lookup) -> None:
    """A LIMIT query: the ORDER BY column's values in order, and each
    returned group's row equal to the CPU engine's row for that group
    (`same_result`'s tolerances). The card orders by f32 sums and the CPU
    engine by f64 ones, and either engine picks any of the groups tied at
    the cut: a returned group the CPU engine did not return is looked up
    (`lookup(groups)` -> its rows on the CPU engine) and held to its row
    there, no looser."""
    g_rows, c_rows = gpu.to_pylist(), cpu.to_pylist()
    check(len(g_rows) == len(c_rows), f"{name}: {len(g_rows)} rows on gpu vs {len(c_rows)} on cpu")
    for i, (ra, rb) in enumerate(zip(g_rows, c_rows)):
        va, vb = ra[order_col], rb[order_col]
        check(abs(va - vb) <= ABS_TOL + REL_TOL * abs(vb),
              f"{name}: {order_col} of row {i}: gpu {va} vs cpu {vb}")
    want = {tuple(r[k] for k in keys): r for r in c_rows}
    apart = [tuple(r[k] for k in keys) for r in g_rows if tuple(r[k] for k in keys) not in want]
    if apart:
        want.update(lookup(apart))
    for r in g_rows:
        group = tuple(r[k] for k in keys)
        check(group in want, f"{name}: the CPU engine has no group {group}")
        for col, va in r.items():
            vb = want[group][col]
            if isinstance(va, float) and isinstance(vb, float):
                check(abs(va - vb) <= ABS_TOL + REL_TOL * abs(vb), f"{name}.{col} {group}: {va} vs {vb}")
            else:
                check(va == vb, f"{name}.{col} {group}: gpu {va!r} vs cpu {vb!r}")
    if apart:
        log(f"phase 10 {name}: {len(apart)} group(s) at the cut picked apart from the CPU "
            f"engine's (ties or f32 near-ties), each equal to its CPU row: {apart}")


def k8_exact(torch, K, acc, rows: dict, what: str) -> int:
    """K8 against its plain version on the card, bit for bit in the ids and
    the gathered columns, for each kind in `rows` ({kind: (value row, pac
    row, M2 row)}), both orders, k of 1, 10, both sides of the regime
    boundary and TOPK_MAX_K (those up to G), in the rule's regime and in
    every regime that takes k; returns the cases checked."""
    n = 0
    ks = [k for k in (1, 10, K.TOPK_BLOCK_MAX_K, K.TOPK_BLOCK_MAX_K + 1, K.TOPK_MAX_K)
          if k <= acc.shape[1]]
    for kind, (val, pac, sq) in rows.items():
        for desc in (True, False):
            for k in ks:
                pout, pidx = K.topk_groups_plain(acc, kind, val, pac, sq, desc, k)
                for regime in (None, *(r for r in K.REGIMES
                                       if r != "block" or k <= K.TOPK_BLOCK_MAX_K)):
                    out, idx = K.topk_groups(acc, kind, val, pac, sq, desc, k, regime=regime)
                    check(torch.equal(idx, pidx)
                          and torch.equal(out.view(torch.int32), pout.view(torch.int32)),
                          f"K8 not exact: {what} {kind} {'desc' if desc else 'asc'} k={k} "
                          f"regime {regime or K.topk_regime(acc.shape[1], k)}")
                    n += 1
    return n


def topk_case(torch, K, timer, acc, kind: str, val: int, pac: int, sq: int, desc: bool,
              k: int, inputs: str) -> dict:
    """K8 vs its plain version, bit for bit, then timed L2-cold and L2-warm
    beside its plain version and the library's pick: torch.topk over the
    same int32 scores plus one index_select gather. Bound: the rows its
    score reads once, the k columns gathered and written, the k ids."""
    r, g = acc.shape
    res = {"shape": f"R={r} G={g} k={k} {kind} {'desc' if desc else 'asc'}", "inputs": inputs,
           "regime": K.topk_regime(g, k)}
    k8_exact(torch, K, acc, {kind: (val, pac, sq)}, inputs)
    res["max_abs_err"] = 0.0
    read = {0, pac, val} | ({sq} if kind in ("var", "stddev") else set())
    nbytes = 4 * g * len(read) + 2 * 4 * r * k + 4 * k
    copies = n_copies(nbytes)
    sets = [acc] + [acc.clone() for _ in range(copies - 1)]
    scores = [K.scores_plain(a, kind, val, pac, sq, desc) for a in sets]
    fns = {
        "ms": lambda j: K.topk_groups(sets[j], kind, val, pac, sq, desc, k),
        "plain_ms": lambda j: K.topk_groups_plain(sets[j], kind, val, pac, sq, desc, k),
        "library_ms": lambda j: sets[j].index_select(1, torch.topk(scores[j], k).indices),
    }
    res.update(timed(timer, fns, copies))
    per_kernel, seen = profiled_ms(torch, fns["ms"], (KERNEL_SYMBOLS["topk_groups"],))
    # the C entry launches 1 kernel a call in the block regime, 12 in the
    # radix regime (score, 8 select passes, compact, sort, gather). Late in a
    # run the profiler drops records (launches a call are read from the
    # profiled queries, `K8_PROFILED`): a dropped record lowers `seen`, and
    # none raises it.
    launches = 1 if res["regime"] == "block" else 12
    res["profiler_ms"] = per_kernel * launches if per_kernel else None
    res["profiler_kernels"] = seen
    check(seen <= 10 * launches, f"K8 {res['regime']}: {seen} kernels in 10 calls ({res['shape']})")
    res["sum_ms"] = stream_sum_ms(torch, timer, nbytes)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 8 * g)
    res["bytes"] = nbytes
    res["copies"] = copies
    return res


def drive_highcard(torch, seed: int, timer, device=None, then=None
                   ) -> tuple[dict, dict | None, "K3Recorder", dict, dict]:
    """Phase 10: high cardinality. A lake of bench.py's "highcard" profile
    (8 one-minute files of 2^20 rows, a stream of its own) and HC_QUERIES on
    the "gpu" engine (on `device`, default the card) cold, disk-warm and
    device-warm, and on the "cpu" engine: the same answers (`same_table`,
    `same_top`), no block off the card, the local queries block-local
    (`device_local`), K8 launched by hc_topk_path. On the card, K8 against
    its plain version on hc_topk_path's own accumulator and on
    `topk_hazard_acc`, bit for bit, then timed on that accumulator
    (`topk_case`). Then phase 11 (a) on this lake: hc_minute_path under a
    degraded link (`gate_runs`), and `then(p)` (phase 12's part on this
    lake) before the lake goes. Returns the phase's launch counts, K8's
    timing (None off the card), the queries' K3 calls, each query's first
    call of A, B and K7 at each shape, inputs cloned, with its call count,
    and phase 11's walls on this lake."""
    import numpy as np

    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops import groupby_cuda as G
    from parseable_tpu_torch.ops import stats_cuda as SC
    from parseable_tpu_torch.ops import topk_cuda as K
    from parseable_tpu_torch.ops.enccache import shutdown_enccache
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.session import QuerySession

    on_card = device is None or torch.device(device).type == "cuda"
    work = ROOT / "build" / "smoke_hc"
    shutil.rmtree(work, ignore_errors=True)
    counts = kernel_counters()
    recorded: dict[str, tuple] = {}
    current = [None]
    real_topk = K.topk_groups
    real = {"additive_groupby": G.additive_groupby, "minmax_groupby": G.minmax_groupby,
            "centered_m2": SC.centered_m2}
    # {kernel: {(query, shape): [its first call's inputs, cloned, calls]}}
    calls: dict[str, dict] = {name: {} for name in real}

    def rec_topk(acc, *args):
        if current[0] not in recorded:
            recorded[current[0]] = (acc.clone(), *args)
        return real_topk(acc, *args)

    def record(name, key, tensors):
        seen = calls[name].setdefault((current[0], key), [None, 0])
        if seen[0] is None:
            seen[0] = tuple(t.clone() for t in tensors)
        seen[1] += 1

    def rec_a(ids, rows, g, **kw):
        record("additive_groupby", (rows.shape[0], rows.shape[1], g), (ids, rows))
        return real["additive_groupby"](ids, rows, g, **kw)

    def rec_b(ids, vals, valid, mask, g, n_min, **kw):
        record("minmax_groupby", (vals.shape[0], n_min, vals.shape[1], g), (ids, vals, valid, mask))
        return real["minmax_groupby"](ids, vals, valid, mask, g, n_min, **kw)

    def rec_k7(ids, vals, valid, mask, mean, **kw):
        record("centered_m2", (vals.shape[0], vals.shape[1], mean.shape[1]),
               (ids, vals, valid, mask, mean))
        return real["centered_m2"](ids, vals, valid, mask, mean, **kw)

    p = None
    try:
        p = build_lake(work, seed + 10, HC_MINUTES, N_BLOCK, HC_STREAM, make_hc_minute, "phase 10")
        reset_launches(counts)
        K.topk_groups = rec_topk
        G.additive_groupby, G.minmax_groupby, SC.centered_m2 = rec_a, rec_b, rec_k7
        with K3Recorder(F) as k3:
            for qname, (sql, keys, order_col) in HC_QUERIES.items():
                k3.query = current[0] = qname
                text = sql.format(stream=HC_STREAM)

                def lookup(groups, keys=keys, text=text):
                    # the query itself, restricted to `groups`, without ORDER BY and LIMIT
                    conds = " AND ".join(
                        f"{k} IN ({', '.join(repr(str(g[i])) for g in groups)})"
                        for i, k in enumerate(keys))
                    head, tail = text.split(" GROUP BY ", 1)
                    q = f"{head} WHERE {conds} GROUP BY {tail.split(' ORDER BY ', 1)[0]}"
                    rows = QuerySession(p, engine="cpu").query(q).table.to_pylist()
                    return {tuple(r[k] for k in keys): r for r in rows}

                if order_col is None:
                    def compare(n, g, c, keys=keys):
                        same_table(n, g, c, keys)
                else:
                    def compare(n, g, c, keys=keys, order_col=order_col, lookup=lookup):
                        same_top(n, g, c, keys, order_col, lookup)

                before = launch_counts(counts)
                out = state_runs(torch, p, qname, text, "phase 10", device, states=HC_STATES,
                                 compare=compare)
                delta = {k: v - before[k] for k, v in launch_counts(counts).items()}
                for res in out:
                    r = res.stats["device_routes"]
                    check((r["device_local"] > 0) == (qname in HC_LOCAL),
                          f"{qname}: device_local {r['device_local']}")
                if on_card:
                    check(delta["mask_ids"] > 0 and delta["additive_groupby"] > 0,
                          f"{qname}: a kernel never launched {delta}")
                    check((delta["topk_groups"] > 0) == (qname == "hc_topk_path"),
                          f"{qname}: K8 launches {delta['topk_groups']}")
                    if qname == "hc_minute_path":
                        check(delta["minmax_groupby"] > 0 and delta["centered_m2"] > 0,
                              f"{qname}: B or K7 never launched {delta}")
                log(f"phase 10 {qname}: gpu == cpu in {len(HC_STATES)} cache states, "
                    f"launches {delta}")
        K.topk_groups = real_topk
        G.additive_groupby, G.minmax_groupby = real["additive_groupby"], real["minmax_groupby"]
        SC.centered_m2 = real["centered_m2"]
        launches = launch_counts(counts)
        log(f"phase 10 launches: {launches}")
        log_residency(torch, "phase 10", on_card)
        # phase 11 (a) on this lake: the local-mode query under a degraded link
        t = time.perf_counter()
        reset_launches(counts)
        sql, keys, _ = HC_QUERIES["hc_minute_path"]
        gate = gate_runs(torch, p, [("hc_minute_path", sql.format(stream=HC_STREAM),
                                     lambda n, g, c: same_table(n, g, c, keys))], "phase 11", device)
        log(f"phase 11 (highcard lake) launches {launch_counts(counts)}, "
            f"{time.perf_counter() - t:.3f} s")
        if then is not None:
            then(p)
    finally:
        K.topk_groups = real_topk
        G.additive_groupby, G.minmax_groupby = real["additive_groupby"], real["minmax_groupby"]
        SC.centered_m2 = real["centered_m2"]
        if p is not None:
            p.shutdown()
        get_hotset().clear()
        shutdown_enccache()
        shutil.rmtree(work, ignore_errors=True)
    if not on_card:
        return launches, None, k3, calls, gate
    # K8 on the card: hc_topk_path's own accumulator, every kind scoring the
    # rows the query's call read (its value row also as the M2 row), then the
    # hazard set, bit for bit
    acc, kind, val, pac, sq, desc, k = recorded["hc_topk_path"]
    n_own = k8_exact(torch, K, acc, dict.fromkeys(K.KINDS, (val, pac, val)),
                     "hc_topk_path's accumulator")
    hazard = torch.from_numpy(topk_hazard_acc(np, np.random.default_rng(seed), 12, acc.shape[1], 5))
    n_hazard = k8_exact(torch, K, hazard.cuda(), dict.fromkeys(K.KINDS, (6, 3, 9)), "hazard set")
    log(f"phase 10 K8 exact: {n_own} cases on hc_topk_path's accumulator {tuple(acc.shape)}, "
        f"{n_hazard} on the hazard set (ties, NaN, +-inf, +-3.4e38, +-0.0, subnormals, NULL "
        f"aggregates, empty slots)")
    res = topk_case(torch, K, timer, acc, kind, val, pac, sq, desc, k, "main path")
    log(f"phase 10 topk_groups {json.dumps(res)}")
    return launches, res, k3, calls, gate


# ------------------------------------------------------ phase 12: the mesh

# the query lake's queries that phase 12 runs under a mesh, and their
# answers' tolerances against the one-device run and the CPU engine
MESH_QUERIES = ("groupby", "minmax", "topk_multicol", "stats_status", "stats_minute",
                "select_filter")
MESH_STATES = ("disk-warm", "device-warm")


def mesh_queries() -> list:
    """MESH_QUERIES as `mesh_runs` takes them."""
    runs = []
    for q in MESH_QUERIES:
        if q in SELECT_QUERIES:
            sql, key = SELECT_QUERIES[q]
            runs.append((q, sql.format(stream=STREAM),
                         lambda n, g, c, key=key: same_select(n, g, c, key), (key,)))
        elif q in STATS_QUERIES:
            runs.append((q, STATS_QUERIES[q].format(stream=STREAM),
                         lambda n, g, c: same_result(n, g, c, STATS_REL), None))
        else:
            runs.append((q, QUERIES[q].format(stream=STREAM), same_result, None))
    return runs


def mesh_layouts(torch, device=None) -> list:
    """Phase 12's meshes: a virtual mesh of 4 shards on the first card (on
    `device`, when one is given) and a virtual 2 x 2 (data x groups), then,
    where the machine has several cards, the same over the real cards."""
    from parseable_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    out = [("4 virtual", make_mesh(4, devices=[dev] * 4)),
           ("2x2 virtual", make_mesh_2d(2, 2, [dev] * 4))]
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > 1:
        real = 1 << (min(n, 4).bit_length() - 1)
        out.append((f"{real} cards", make_mesh(real)))
        if n >= 4:
            out.append(("2x2 cards", make_mesh_2d(2, 2)))
    return out


class K10Recorder:
    """Records K10's first call at each shape (its stacked partials, cloned,
    and its row ops) and counts its calls, while the executor runs."""

    def __init__(self, MC):
        self.MC = MC
        self.calls: dict[tuple, list] = {}

    def __enter__(self):
        self.real = self.MC.mesh_combine

        def rec(parts, desc):
            seen = self.calls.setdefault(tuple(parts.shape), [None, 0])
            if seen[0] is None:
                seen[0] = (parts.clone(), list(desc))
            seen[1] += 1
            return self.real(parts, desc)

        self.MC.mesh_combine = rec
        return self

    def __exit__(self, *exc):
        self.MC.mesh_combine = self.real


def mesh_runs(torch, p, runs: list, phase: str, states: tuple = MESH_STATES,
              layouts: tuple | None = None, device=None) -> None:
    """Phase 12: each of `runs` ((name, SQL, compare, select: a select's
    `state_runs` argument, else None)) first on one device
    (device-warm), then under each of `mesh_layouts` through `state_runs`
    (which logs the walls and holds the CPU engine's answer), each answer
    also held against the one-device answer; every mesh run folds its
    blocks row-sharded (`device_mesh`), none unsharded, none on the host.
    `layouts` keeps the meshes whose names start with one of its words."""
    from parseable_tpu_torch.parallel.mesh import pin_mesh
    from parseable_tpu_torch.query.session import QuerySession

    for qname, text, compare, select in runs:
        one = QuerySession(p, engine="gpu", device=device).query(text)
        one = QuerySession(p, engine="gpu", device=device).query(text)  # device-warm
        r1 = one.stats["device_routes"]
        check(r1["device_mesh"] == 0 and r1["cpu_fallback"] == 0, f"{qname} one device: {r1}")
        for mname, mesh in mesh_layouts(torch, device):
            if layouts is not None and not mname.startswith(layouts):
                continue
            with pin_mesh(mesh):
                out = state_runs(torch, p, qname, text, f"{phase} {mname}", device, states=states,
                                 compare=None if select else compare, select=select)
            for res in out:
                r = res.stats["device_routes"]
                check(r["device_mesh"] == r["device_warm"] + r["device_cold"] > 0
                      and r["mesh_unsharded"] == 0, f"{qname} {mname}: routes {r}")
                compare(f"{qname} {mname} vs one device", res.table, one.table)
        log(f"{phase} {qname}: every mesh's answer == one device's == cpu, device_mesh > 0")


def k10_hazards(np, rng, d: int, w: int):
    """K10's hazard set (tests/test_torch_mesh.py (b)): [D, 7, W] partials
    of one accumulator layout (count | n | s | M2 | min | max | a flat SUM
    row), shard 0 empty where D > 1, the last group empty on every shard,
    NaN, +-inf, +-3.4e38 and +-0.0 in the MIN and MAX rows."""
    n = rng.integers(0, 100, (d, w)).astype(np.float32)
    if d > 1:
        n[0] = 0
    n[:, -1] = 0
    s = (rng.standard_normal((d, w)) * 10 + 5).astype(np.float32) * n
    m2 = (rng.random((d, w)) * 50).astype(np.float32) * (n > 1)
    mn = np.where(n > 0, rng.standard_normal((d, w)).astype(np.float32), np.float32(np.inf))
    mx = np.where(n > 0, rng.standard_normal((d, w)).astype(np.float32) + 3, np.float32(-np.inf))
    pool = np.array([np.nan, np.inf, -np.inf, 3.4e38, -3.4e38, -0.0, 0.0], np.float32)
    for row in (mn, mx):
        pick = rng.random((d, w)) < 0.05
        row[pick] = rng.choice(pool, int(pick.sum()))
    flat = rng.integers(0, 5, (d, w)).astype(np.float32)
    return np.stack([n, n, s, m2, mn, mx, flat], axis=1)


K10_HAZARD_DESC = ((0, 0, 0), (0, 0, 0), (0, 0, 0), (3, 1, 2), (1, 0, 0), (2, 0, 0), (0, 0, 0))


def k10_exact(torch, MC, parts, desc, what: str) -> float:
    """K10 against its plain version on the card: bit for bit, a NaN
    matching any NaN. Returns the largest absolute difference over the
    finite entries (0.0)."""
    got = MC.mesh_combine(parts, desc)
    want = MC.mesh_combine_plain(parts, desc)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan)
          and torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]),
          f"K10 not exact: {what}")
    fin = torch.isfinite(want)
    return float((got - want)[fin].abs().max().item()) if bool(fin.any()) else 0.0


def library_combine(torch, MC, desc):
    """One PyTorch expression per op over the same stack, the yardstick of
    K10 (used nowhere in the port): torch.sum / amin / amax over dim 0 of
    the SUM / MIN / MAX rows, and Chan's recentre of the M2 rows in torch
    ops."""
    rows = {op: [r for r, (o, _, _) in enumerate(desc) if o == op] for op in range(4)}
    m2 = [(r, n, s) for r, (o, n, s) in enumerate(desc) if o == MC.M2]
    idx = {op: torch.tensor(v, device="cuda") for op, v in rows.items() if v}
    if m2:
        r_, n_, s_ = (torch.tensor(c, device="cuda") for c in zip(*m2))

    def run(parts):
        out = torch.empty(parts.shape[1:], device=parts.device)
        for op, fn in ((MC.SUM, torch.sum), (MC.MIN, torch.amin), (MC.MAX, torch.amax)):
            if op in idx:
                out[idx[op]] = fn(parts[:, idx[op]], dim=0)
        if m2:
            n, s = parts[:, n_], parts[:, s_]
            mean_t = s.sum(0) / n.sum(0).clamp_min(1.0)
            dev = s / n.clamp_min(1.0) - mean_t
            out[r_] = torch.where(n > 0, parts[:, r_] + n * dev * dev, 0.0).sum(0)
        return out

    return run


def k10_case(torch, MC, timer, parts, desc, inputs: str) -> dict:
    """K10 vs its plain version, bit for bit, then timed L2-cold and L2-warm
    beside its plain version and `library_combine`. Bound: the D partials
    read once and the result written once, (D + 1) R W 4 bytes."""
    d, r, w = parts.shape
    res = {"shape": f"D={d} R={r} W={w}", "inputs": inputs, "regime": "a thread a column"}
    res["max_abs_err"] = k10_exact(torch, MC, parts, desc, inputs)
    nbytes = (d + 1) * r * w * 4
    copies = n_copies(nbytes)
    sets = [parts] + [parts.clone() for _ in range(copies - 1)]
    lib = library_combine(torch, MC, desc)
    fns = {
        "ms": lambda k: MC.mesh_combine(sets[k], desc),
        "plain_ms": lambda k: MC.mesh_combine_plain(sets[k], desc),
        "library_ms": lambda k: lib(sets[k]),
    }
    res.update(timed(timer, fns, copies))
    res["profiler_ms"], res["profiler_kernels"] = profiled_ms(torch, fns["ms"],
                                                              (KERNEL_SYMBOLS["mesh_combine"],))
    res["sum_ms"] = stream_sum_ms(torch, timer, nbytes)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, d * r * w)
    check(abs(res["bound_ms"] - MC.bound_ms(d, r, w)) <= 1e-9, "K10's bound")
    res["copies"] = copies
    return res


def k10_checks(torch, MC, timer, seed: int, recorded: dict) -> tuple[dict, int]:
    """Phase 12 on the card: K10 bit for bit against its plain version on
    every shape the phase gave it (its first call's own partials) and on
    the hazard set at D = 1, 2, 4 and 8; then timed at the phase's heaviest
    shape. Returns the timing and the cases checked."""
    import numpy as np

    n = 0
    for shape, (first, calls) in sorted(recorded.items()):
        parts, desc = first
        k10_exact(torch, MC, parts, desc, f"phase 12's call at {shape} ({calls} calls)")
        n += 1
    rng = np.random.default_rng(seed)
    for d in (1, 2, 4, 8):
        for w in (1, 4099, 1 << 17):
            parts = torch.from_numpy(k10_hazards(np, rng, d, w)).cuda()
            k10_exact(torch, MC, parts, K10_HAZARD_DESC, f"hazard set D={d} W={w}")
            n += 1
    shape = max(recorded, key=lambda s: s[0] * s[1] * s[2])
    parts, desc = recorded[shape][0]
    res = k10_case(torch, MC, timer, parts, desc, "main path, phase 12")
    res["main_path_calls"] = recorded[shape][1]
    return res, n


# ------------------------------------------------- gate and result cache

WARM_DEADLINE_S = 300  # the warmer lands every routed block within this
# the API time range of phase 11's result-cache runs: the whole lake, and
# far before the staging window, so the queries can use the cache
LAKE_RANGE = {"start_time": "2024-05-01T00:00:00Z", "end_time": "2024-05-02T00:00:00Z"}


def slow_link():
    """A link profile taught a degraded link: every copy, either way and of
    any size, takes 1.1 s (tests/test_adaptive_link.py's slow link, with
    its latency taught too, so that the block copies the warmer times on
    the card cannot teach it a fast link in the middle of a query)."""
    from parseable_tpu_torch.ops.link import LinkProfile

    prof = LinkProfile()
    for _ in range(20):
        for nbytes in (1 << 10, 1 << 20):
            prof.record_h2d(nbytes, 1.1)
            prof.record_d2h(nbytes, 1.1)
    return prof


def gate_runs(torch, p, runs: list, phase: str, device=None) -> dict:
    """Phase 11 (a): each query in `runs` ((name, text, compare(name, gpu,
    cpu))) on the "gpu" engine cold on the card's measured profile, then
    cold under a degraded link (`slow_link`, pinned): every block goes to
    the host (`cpu_adaptive` == the blocks scanned) and the answer equals
    the CPU engine's; the warmer then lands every routed block in the hot
    set before WARM_DEADLINE_S, and with the measured profile back the next
    run is device-warm. Returns each query's walls (ms) and warm time."""
    from parseable_tpu_torch.ops import link as L
    from parseable_tpu_torch.ops.enccache import get_enccache
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.session import QuerySession

    on_card = device is None or torch.device(device).type == "cuda"
    cache = get_enccache(p.options)

    def cold() -> None:
        get_hotset().clear()
        cache.wait_idle()
        for f in cache.root.glob("*.enc"):
            f.unlink()

    def timed(text: str):
        t = time.perf_counter()
        res = QuerySession(p, engine="gpu", device=device).query(text)
        if on_card:
            torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    out = {}
    for qname, text, compare in runs:
        cpu = QuerySession(p, engine="cpu").query(text)
        cold()
        measured, measured_ms = timed(text)
        r = measured.stats["device_routes"]
        check(r["cpu_adaptive"] == r["cpu_fallback"] == 0, f"{qname} measured cold: {r}")
        cold()
        with L.pin_link(slow_link()):
            degraded, degraded_ms = timed(text)
        r, st = degraded.stats["device_routes"], degraded.stats
        blocks = st["files_total"] - st["files_pruned"]
        check(blocks > 0 and st["rows_scanned"] >= blocks * (1 << 16),
              f"{qname}: {blocks} blocks, {st['rows_scanned']} rows")
        check((r["cpu_adaptive"], r["cpu_fallback"], r["device_warm"], r["device_cold"])
              == (blocks, 0, 0, 0), f"{qname} degraded: {blocks} blocks but routes {r}")
        compare(f"{qname} degraded", degraded.table, cpu.table)
        t = time.perf_counter()
        while get_hotset().stats_snapshot()["entries"] < blocks:
            check(time.perf_counter() - t < WARM_DEADLINE_S,
                  f"{qname}: the warmer landed {get_hotset().stats_snapshot()['entries']} of "
                  f"{blocks} blocks in {WARM_DEADLINE_S} s")
            time.sleep(0.01)
        warmed_ms = (time.perf_counter() - t) * 1e3
        L.shutdown_warmer()
        warm, warm_ms = timed(text)
        r = warm.stats["device_routes"]
        check((r["device_warm"], r["device_cold"], r["cpu_adaptive"], r["cpu_fallback"])
              == (blocks, 0, 0, 0), f"{qname} after the warmer: {blocks} blocks but routes {r}")
        compare(f"{qname} warmed", warm.table, cpu.table)
        out[qname] = {"cold_measured_ms": measured_ms, "cold_degraded_ms": degraded_ms,
                      "warmer_landed_ms_after_query": warmed_ms, "device_warm_ms": warm_ms,
                      "blocks": blocks}
        log(f"{phase} gate {qname}: {blocks} blocks; cold on the measured profile wall "
            f"{measured_ms:.3f} ms, cold on the degraded link wall {degraded_ms:.3f} ms (every "
            f"block on the host, answer == cpu, stages "
            f"{ {k: v for k, v in degraded.stats['stages'].items() if k != 'hotset'} }), the "
            f"warmer landed the last block {warmed_ms:.3f} ms after the query, then device-warm "
            f"on the measured profile wall {warm_ms:.3f} ms")
    return out


def result_cache_runs(torch, p, device=None) -> dict:
    """Phase 11 (b), on the phase 3 lake with a 64 MiB result cache: the
    groupby query over LAKE_RANGE twice (a miss, then a hit whose table
    equals the miss's); the same query without a range (it reaches the
    staging window: no cache); then a new minute synced into the lake,
    whose snapshot commit evicts the entry, so the next run is a miss that
    counts the new rows. Returns the walls (ms)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from parseable_tpu_torch.query.partials import get_result_cache
    from parseable_tpu_torch.query.session import QuerySession

    on_card = device is None or torch.device(device).type == "cuda"
    text = QUERIES["groupby"].format(stream=STREAM)

    def timed(**span):
        t = time.perf_counter()
        res = QuerySession(p, engine="gpu", device=device).query(text, **span)
        if on_card:
            torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    def rows(res) -> int:
        return int(pc.sum(res.table["c"]).as_py())

    p.options.query_result_cache_bytes = 64 << 20
    try:
        cache = get_result_cache(p.options)
        miss, miss_ms = timed(**LAKE_RANGE)
        hit, hit_ms = timed(**LAKE_RANGE)
        check((miss.stats["stages"]["result_cache"], hit.stats["stages"]["result_cache"])
              == ("miss", "hit"), f"result cache: {miss.stats['stages']} then {hit.stats['stages']}")
        check(hit.table.equals(miss.table), "result cache: the hit's table differs from the miss's")
        check("device_routes" not in hit.stats and hit.stats["rows_scanned"] == 0,
              f"result cache: the hit scanned {hit.stats}")
        check(rows(miss) == MINUTES * N_BLOCK, f"result cache: {rows(miss)} rows counted")
        same_result("groupby result cache miss", miss.table,
                    QuerySession(p, engine="cpu").query(text, **LAKE_RANGE).table)
        inside, inside_ms = timed()
        check(inside.stats["stages"]["result_cache"] is None,
              f"result cache: a query reaching the staging window has {inside.stats['stages']}")
        t = time.perf_counter()
        stream = p.create_stream_if_not_exists(STREAM)
        stream.write_parquet(make_minute(pa, np, np.random.default_rng(MINUTES), MINUTES, N_BLOCK),
                             BASE + timedelta(minutes=MINUTES))
        p.sync_all_streams()  # update_snapshot evicts the stream's entries
        sync_ms = (time.perf_counter() - t) * 1e3
        after, after_ms = timed(**LAKE_RANGE)
        check(after.stats["stages"]["result_cache"] == "miss",
              f"result cache: after the sync {after.stats['stages']}")
        check(rows(after) == (MINUTES + 1) * N_BLOCK, f"result cache: {rows(after)} rows after sync")
    finally:
        p.options.query_result_cache_bytes = 0
    walls = {"miss_ms": miss_ms, "hit_ms": hit_ms, "staging_window_ms": inside_ms,
             "new_minute_sync_ms": sync_ms, "miss_after_sync_ms": after_ms}
    log(f"phase 11 result cache groupby: miss wall {miss_ms:.3f} ms, hit wall {hit_ms:.3f} ms "
        f"(hit table == miss table; hit stages {hit.stats['stages']}), inside the staging window (no cache) {inside_ms:.3f} ms, "
        f"a new minute synced in {sync_ms:.3f} ms evicted the entry, next run a miss counting "
        f"{rows(after)} rows in {after_ms:.3f} ms; cache hits {cache.hits} misses {cache.misses}")
    return walls


# ------------------------------------------------------------------ server

N_EVENTS = 1 << 20  # events sent over HTTP in phase 6
EVENTS_PER_REQUEST = 1 << 14
CLIENTS = 4
EXTRA_EVENTS = 1000  # a last batch the short sync ticks must move into the lake
PYTHON_PARSE_BODIES = 16  # bodies the Python lane parses in phase 6's parse line
SERVER_QUERIES = {
    "count": "SELECT count(*) AS c FROM {stream}",
    "status": (
        "SELECT status, count(*) AS c, sum(bytes) AS b, min(latency_ms) AS mn, "
        "max(bytes) AS mx FROM {stream} GROUP BY status"
    ),
    "regex_filter": QUERIES["regex_filter"],
    # `ORDER BY 4` would sort by the constant 4 in both packages (neither
    # resolves ordinals), so the sum is named
    "topk_multicol": QUERIES["topk_multicol"],
}


def make_events(np, rng, n: int) -> dict:
    """`n` events of `make_minute`'s access-log profile (the same columns and
    value sets, numbers as JSON numbers), as numpy columns; the server
    stamps p_timestamp on arrival."""
    hosts = np.array([f"10.0.{i}.{j}" for i in range(4) for j in range(8)])
    paths = np.array([f"/api/v1/resource{i}" for i in range(64)])
    messages = np.array(
        [f"request completed in {d}ms" for d in range(0, 400, 25)]
        + [f"error: upstream timeout after {d}ms" for d in range(0, 400, 50)]
        + [f"slow query warning threshold {d}" for d in range(0, 200, 25)]
        + ["connection reset by peer", "error: permission denied", "cache miss"]
    )
    statuses = np.array([200, 200, 200, 200, 301, 404, 500, 503])
    methods = np.array(["GET", "GET", "GET", "POST", "PUT", "DELETE"])
    return {
        "host": hosts[rng.integers(0, len(hosts), n)],
        "method": methods[rng.integers(0, len(methods), n)],
        "path": paths[rng.integers(0, len(paths), n)],
        "message": messages[rng.integers(0, len(messages), n)],
        "status": statuses[rng.integers(0, len(statuses), n)],
        "bytes": rng.integers(100, 50_000, n),
        "latency_ms": rng.random(n) * 500,
    }


def request_bodies(cols: dict, per_request: int) -> list[bytes]:
    """JSON array bodies of `per_request` events each."""
    names = list(cols)
    lists = [cols[c].tolist() for c in names]
    n = len(lists[0])
    return [
        json.dumps([dict(zip(names, row)) for row in zip(*(l[o : o + per_request] for l in lists))]).encode()
        for o in range(0, n, per_request)
    ]


def oracle(np, cols: dict) -> dict:
    """The answers of SERVER_QUERIES over the events sent, in numpy (f64)."""
    status = cols["status"].astype(np.float64)
    nbytes = cols["bytes"].astype(np.float64)
    lat = cols["latency_ms"]
    out = {"count": {(): {"c": len(status)}}, "status": {}, "regex_filter": {}, "topk_multicol": {}}
    err = np.char.find(cols["message"].astype(str), "error") >= 0
    for s in np.unique(status):
        m = status == s
        out["status"][(s,)] = {
            "c": int(m.sum()), "b": float(nbytes[m].sum()),
            "mn": float(lat[m].min()), "mx": float(nbytes[m].max()),
        }
        me = m & err
        if me.any():
            out["regex_filter"][(s,)] = {"c": int(me.sum()), "l": float(lat[me].mean())}
    keys = np.char.add(np.char.add(cols["path"].astype(str), "|"), cols["host"].astype(str))
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=nbytes)
    counts = np.bincount(inv)
    for i in np.argsort(-sums)[:10]:
        path, host = uniq[i].split("|")
        out["topk_multicol"][(path, host)] = {"c": int(counts[i]), "s": float(sums[i])}
    return out


def close(a: float, b: float) -> bool:
    return abs(a - b) <= ABS_TOL + REL_TOL * abs(b)


def check_against_oracle(qname: str, records: list[dict], want: dict, where: str) -> None:
    """Counts exact, floats within REL_TOL/ABS_TOL; the top-10 by sum must
    hold the oracle's ten sums in descending order (keys may swap only
    between sums equal within tolerance)."""
    key_cols = {"count": (), "status": ("status",), "regex_filter": ("status",),
                "topk_multicol": ("path", "host")}[qname]
    check(len(records) == len(want), f"{where} {qname}: {len(records)} rows, oracle {len(want)}")
    if qname == "topk_multicol":
        got_s = [r["s"] for r in records]
        check(got_s == sorted(got_s, reverse=True), f"{where} {qname}: not sorted by s desc")
        want_s = sorted((v["s"] for v in want.values()), reverse=True)
        check(all(close(a, b) for a, b in zip(got_s, want_s)), f"{where} {qname}: top sums differ")
    for r in records:
        key = tuple(r[c] for c in key_cols)
        if qname == "topk_multicol" and key not in want:
            continue  # a tie at rank 10, the sum already checked above
        check(key in want, f"{where} {qname}: group {key} not in the oracle")
        for col, v in want[key].items():
            ok = r[col] == v if isinstance(v, int) else close(r[col], v)
            check(ok, f"{where} {qname} {key}.{col}: {r[col]} vs oracle {v}")


def same_records(name: str, a: list[dict], b: list[dict]) -> None:
    import pyarrow as pa

    same_result(name, pa.Table.from_pylist(a), pa.Table.from_pylist(b))


def http_call(port: int, method: str, path: str, body: bytes | None = None, headers=None):
    import base64
    import urllib.error
    import urllib.request

    auth = "Basic " + base64.b64encode(b"admin:admin").decode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"Authorization": auth, "Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def http_query(port: int, sql: str) -> tuple[dict, float]:
    body = json.dumps(
        {"query": sql, "startTime": "10m", "endTime": "now", "fields": True}
    ).encode()
    t = time.perf_counter()
    status, out = http_call(port, "POST", "/api/v1/query", body)
    wall = time.perf_counter() - t
    check(status == 200, f"query {sql!r}: HTTP {status} {out}")
    return out, wall


def parse_rates(bodies: list[bytes], python_bodies: int) -> dict:
    """Parse-only rows/s of the ingest bodies, one body at a time, through
    each tier of the native ingest ladder: columnar with the module's shard
    count and with one shard (to Arrow arrays), NDJSON (to NDJSON, then
    pyarrow's reader), and the Python lane (json.loads and flatten, on the
    first `python_bodies` bodies), so that parse and HTTP/staging can be
    told apart."""
    import pyarrow as pa
    import pyarrow.json as pj

    from parseable_tpu_torch import native
    from parseable_tpu_torch.config import Options
    from parseable_tpu_torch.server.ingest_utils import flatten_json_records

    opts = Options()
    depth = opts.event_flatten_level - 1

    def columnar(shards):
        def run(body: bytes) -> int:
            r = native.flatten_columnar(body, depth, shards=shards)
            check(r is not None, "the columnar tier declined an ingest body")
            return r[2]
        return run

    def ndjson(body: bytes) -> int:
        r = native.flatten_ndjson(body, depth)
        check(r is not None, "the NDJSON tier declined an ingest body")
        return pj.read_json(pa.BufferReader(r[0])).num_rows

    def python(body: bytes) -> int:
        return len(flatten_json_records(json.loads(body), opts.event_flatten_level, None, None,
                                        None, opts.event_max_chunk_age))

    shards = native._effective_shards(len(bodies[0]), None)
    tiers = {
        f"columnar_x{shards}": (columnar(None), bodies),
        "columnar_x1": (columnar(1), bodies),
        "ndjson": (ndjson, bodies),
        "python": (python, bodies[:python_bodies]),
    }
    out = {}
    for name, (fn, some) in tiers.items():
        t = time.perf_counter()
        rows = sum(fn(b) for b in some)
        dt = time.perf_counter() - t
        check(rows == EVENTS_PER_REQUEST * len(some), f"{name} parsed {rows} rows")
        out[name] = {"bodies": len(some), "rows": rows, "s": round(dt, 4),
                     "rows_per_s": round(rows / dt, 1),
                     "MB_per_s": round(sum(map(len, some)) / dt / 1e6, 1)}
    return out


def send_events(port: int, bodies: list[bytes], clients: int) -> tuple[int, list[float], float]:
    """POST every body to /api/v1/ingest from `clients` threads; returns the
    acked row count, each request's ack latency and the wall time."""
    import threading

    acked: list[int] = []
    lat: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()

    def client(mine: list[bytes]) -> None:
        for body in mine:
            t = time.perf_counter()
            status, out = http_call(port, "POST", "/api/v1/ingest", body, {"X-P-Stream": STREAM})
            dt = time.perf_counter() - t
            with lock:
                if status != 200:
                    errors.append(f"HTTP {status} {out}")
                    return
                acked.append(int(out["message"].split()[1]))
                lat.append(dt)

    threads = [threading.Thread(target=client, args=(bodies[i::clients],)) for i in range(clients)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    check(not errors, f"ingest failed: {errors[:3]}")
    check(len(acked) == len(bodies), f"{len(acked)} of {len(bodies)} ingest requests acked")
    return sum(acked), lat, wall


def server_queries(torch, G, server, want: dict, where: str, profile_status: bool) -> dict:
    """SERVER_QUERIES over HTTP, cold then warm: each answer against the
    oracle and against the port's CPU engine over the same directories;
    every GPU answer stays on the device. Optionally one more warm run of
    the status query under torch.profiler for the device's idle share."""
    from parseable_tpu_torch.query.session import QuerySession

    counts = kernel_counters()
    walls: dict[str, dict] = {}
    for qname, sql in SERVER_QUERIES.items():
        text = sql.format(stream=STREAM)
        before = launch_counts(counts)
        for run in ("cold", "warm"):
            out, wall = http_query(server.port, text)
            walls.setdefault(qname, {})[run] = wall
            routes = out["stats"]["device_routes"]
            check(routes["cpu_fallback"] == 0, f"{where} {qname}: cpu_fallback {routes}")
            check(routes["device_cold"] + routes["device_warm"] > 0,
                  f"{where} {qname}: no block on the device {routes}")
            check(out["stats"]["scan_errors"] == 0, f"{where} {qname}: scan errors")
            check_against_oracle(qname, out["records"], want[qname], where)
            log(
                f"phase 6 {where} {qname} {run}: HTTP wall {wall * 1e3:.3f} ms, "
                f"{out['stats']['rows_scanned']} rows scanned ({out['stats']['staging_rows']} "
                f"from staging, {out['stats']['files_total']} lake files), stages "
                f"{out['stats']['stages']} routes {routes}"
            )
        cpu = QuerySession(server.state.p, engine="cpu").query(text, "10m", "now")
        same_records(f"{where} {qname}", out["records"], cpu.to_json_rows())
        delta = {k: v - before[k] for k, v in launch_counts(counts).items()}
        if profile_status:  # on the card
            check(delta["additive_groupby"] > 0 and delta["mask_ids"] > 0,
                  f"{where} {qname}: a kernel never launched {delta}")
            if qname == "status":
                check(delta["minmax_groupby"] > 0, f"{where} {qname}: kernel B never launched")
            check((delta["topk_groups"] > 0) == (qname == "topk_multicol"),
                  f"{where} {qname}: K8 launches {delta['topk_groups']}")
        log(f"phase 6 {where} {qname}: == oracle == cpu engine, launches {delta}")
    if profile_status:
        profile_idle(torch, server.port, "status", f"phase 6 {where}")
    return walls


def profile_idle(torch, port: int, qname: str, what: str) -> None:
    """One more run of a SERVER_QUERIES query over HTTP under torch.profiler:
    its wall, the device's busy time and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = http_query(port, SERVER_QUERIES[qname].format(stream=STREAM))
        torch.cuda.synchronize()
    busy_us = sum(
        getattr(ev, "self_device_time_total", 0.0)
        for ev in prof.key_averages()
        if str(getattr(ev, "device_type", "")).endswith("CUDA")
    )
    if busy_us:
        log(
            f"{what} {qname} profile: HTTP wall {wall * 1e3:.3f} ms, device busy "
            f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / 1e3 / (wall * 1e3):.4f}"
        )
    else:
        log(f"{what} {qname} profile: the profiler saw no device time (not measured)")


def boot_module(work: Path, acked: int) -> None:
    """`python -m parseable_tpu_torch.server` on the phase's directories:
    it must answer liveness and one query, then stop on SIGTERM."""
    import os
    import signal
    import socket
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "P_ADDR": f"127.0.0.1:{port}",
           "P_STAGING_DIR": str(work / "staging"), "P_FS_DIR": str(work / "data"),
           "P_QUERY_RESULT_CACHE_BYTES": "0"}
    env.pop("P_QUERY_ENGINE", None)
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "parseable_tpu_torch.server"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        live = False
        while time.perf_counter() - t < 180 and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/v1/liveness", timeout=5) as r:
                    live = r.status == 200
            except OSError:
                time.sleep(0.5)
                continue
            break
        check(live, f"python -m parseable_tpu_torch.server never answered liveness "
                    f"(exit {proc.poll()})")
        up = time.perf_counter() - t
        out, wall = http_query(port, SERVER_QUERIES["count"].format(stream=STREAM))
        check(out["records"] == [{"c": acked}], f"module server count {out['records']} != {acked}")
        check(out["stats"]["device_routes"]["cpu_fallback"] == 0, "module server fell back")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        check(code == 0, f"module server exited {code}")
        log(f"phase 6 module: python -m parseable_tpu_torch.server live in {up:.2f} s, "
            f"count(*) {acked} in {wall * 1e3:.3f} ms, stopped with exit 0")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        tail = proc.stdout.read() if proc.stdout else ""
        if proc.returncode not in (0, None):
            log(tail[-4000:])


def drive_server(torch, G, seed: int, device=None) -> dict:
    """Phase 6: the port's HTTP server on the card. 2^20 access-log events
    go in over HTTP; the queries are answered from staging, then, after a
    stop (flush, convert, upload) and a start on the same directories, from
    the lake, then a last batch is moved into the lake by short sync ticks,
    and the server module boots once (on the card only). Returns the
    kernels' launch counts of the phase. `device` as in `drive_main_path`."""
    import numpy as np

    from parseable_tpu_torch.config import Options, StorageOptions
    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops import topk_cuda as K
    from parseable_tpu_torch.server import ingest_utils as IU
    from parseable_tpu_torch.server.app import start_server

    work = ROOT / "build" / "smoke_server"
    shutil.rmtree(work, ignore_errors=True)
    try:
        rng = np.random.default_rng(seed + 1)
        cols = make_events(np, rng, N_EVENTS)
        t = time.perf_counter()
        bodies = request_bodies(cols, EVENTS_PER_REQUEST)
        want = oracle(np, cols)
        log(f"phase 6 events: {N_EVENTS} in {len(bodies)} bodies of {EVENTS_PER_REQUEST}, "
            f"{sum(map(len, bodies))} bytes, encoded in {time.perf_counter() - t:.2f} s")
        log(f"phase 6 parse: {json.dumps(parse_rates(bodies, PYTHON_PARSE_BODIES))}")

        def options(sync_secs: int) -> Options:
            opts = Options()
            opts.address = "127.0.0.1:0"
            opts.local_staging_path = work / "staging"
            opts.query_engine = "gpu"
            opts.local_sync_interval_secs = sync_secs
            opts.upload_interval_secs = sync_secs
            opts.query_result_cache_bytes = 0
            return opts

        storage = StorageOptions(root=work / "data")
        counts = kernel_counters()
        reset_launches(counts)
        # first start: ticks longer than the phase, so the rows stay staged
        on_card = device is None
        server = start_server(options(3600), storage, device)
        try:
            IU.reset_lane_stats()
            acked, lat, wall = send_events(server.port, bodies, CLIENTS)
            lanes = IU.lane_stats()
            check(acked == N_EVENTS, f"{acked} events acked of {N_EVENTS}")
            lat_ms = np.array(lat) * 1e3
            log(
                f"phase 6 ingest: {acked} events acked in {wall:.3f} s = {acked / wall:.6g} rows/s "
                f"({CLIENTS} clients), ack latency p50 {np.percentile(lat_ms, 50):.3f} ms "
                f"p99 {np.percentile(lat_ms, 99):.3f} ms max {lat_ms.max():.3f} ms, "
                f"lanes {json.dumps(lanes)}"
            )
            served = {(lane, r): n for lane, rs in lanes.items() for r, n in rs.items() if n}
            check(served == {("columnar", "hit"): len(bodies)},
                  f"not every ingest request was a columnar hit: {lanes}")
            staging_walls = server_queries(torch, G, server, want, "staging", on_card)
        finally:
            t = time.perf_counter()
            server.stop()
        log(f"phase 6 restart: stop (flush, convert, upload) {time.perf_counter() - t:.3f} s")
        staged = [f for f in (work / "staging" / STREAM).iterdir()
                  if f.name.endswith((".arrows", ".parquet"))]
        check(not staged, f"staging files left after stop: {staged[:3]}")
        # second start: short ticks
        t = time.perf_counter()
        server = start_server(options(1), storage, device)
        log(f"phase 6 restart: start {time.perf_counter() - t:.3f} s")
        try:
            lake_walls = server_queries(torch, G, server, want, "lake", on_card)
            extra = make_events(np, rng, EXTRA_EVENTS)
            more, _, _ = send_events(server.port, request_bodies(extra, EXTRA_EVENTS), 1)
            acked += more
            t = time.perf_counter()
            while True:
                out, _ = http_query(server.port, SERVER_QUERIES["count"].format(stream=STREAM))
                check(out["records"] == [{"c": acked}], f"count {out['records']} != {acked}")
                if out["stats"]["staging_rows"] == 0:
                    break
                check(time.perf_counter() - t < 60, "the sync ticks never moved the last batch")
                time.sleep(0.5)
            log(f"phase 6 sync ticks: {more} more events acked and in the lake after "
                f"{time.perf_counter() - t:.2f} s, count(*) {acked}")
        finally:
            server.stop()
        launches = launch_counts(counts)
        log(f"phase 6 launches on the server path: {launches}")
        log("phase 6 HTTP query wall s: " + json.dumps({"staging": staging_walls, "lake": lake_walls}))
        if on_card:
            for name in (*G.LAUNCHES, *F.LAUNCHES, *K.LAUNCHES):
                check(launches[name] > 0, f"{name} was never launched on the server path")
            boot_module(work, acked)
        return launches
    finally:
        from parseable_tpu_torch.ops.link import get_link

        get_link().flush()  # now, not at exit into a deleted directory
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------- phase 13: cluster

CLUSTER_INGESTORS = 2
# what phase 13 asks the querier: phase 6's queries, a statistics query and
# a select, plus count(distinct) and approx_distinct by status (K5): the
# statistics query has no distinct aggregate, and the other one bins by
# minute, which an oracle of the events sent cannot know
CLUSTER_QUERIES = {
    **SERVER_QUERIES,
    "stats_status": STATS_QUERIES["stats_status"],
    "stats_distinct": (
        "SELECT status, count(distinct path) AS paths, approx_distinct(host) AS hosts "
        "FROM {stream} GROUP BY status"
    ),
    "select_filter": SELECT_QUERIES["select_filter"][0],
}
PUSHED = ("status", "regex_filter", "topk_multicol")  # the partializable GROUP BYs
# the querier's settings per run: whether it scatters, and over which tier
CLUSTER_MODES = {
    "pushdown, flight": {"query_pushdown": True, "flight_client": True},
    "pushdown, http": {"query_pushdown": True, "flight_client": False},
    "central": {"query_pushdown": False, "flight_client": True},
}
HLL_REL = 0.05  # approx_distinct against the exact count: 3 x 1.04 / sqrt(4096)


def cluster_oracle(np, cols: dict) -> dict:
    """`oracle` plus the answers of the statistics queries and the select
    over the events sent, in numpy (f64)."""
    out = oracle(np, cols)
    status, lat, nbytes = cols["status"], cols["latency_ms"], cols["bytes"].astype(np.float64)
    out["stats_status"], out["stats_distinct"] = {}, {}
    for s in np.unique(status):
        m = status == s
        out["stats_status"][(float(s),)] = {
            "c": int(m.sum()), "sd": float(lat[m].std(ddof=1)), "vb": float(nbytes[m].var(ddof=1)),
            "p99": float(np.percentile(lat[m], 99)), "p50": float(np.median(nbytes[m])),
        }
        out["stats_distinct"][(float(s),)] = {
            "paths": len(np.unique(cols["path"][m])), "hosts": len(np.unique(cols["host"][m])),
        }
    keep = (np.isin(cols["host"], ["10.0.0.1", "10.0.1.2"])
            & (np.char.find(cols["path"].astype(str), "resource1") < 0) & (lat > 250))
    out["select_filter"] = sorted(zip(cols["host"][keep].tolist(), cols["path"][keep].tolist(),
                                      status[keep].tolist(), lat[keep].tolist()))
    return out


def check_cluster_answer(qname: str, records: list[dict], want: dict, where: str) -> None:
    """Phase 6's oracle check, and for the other queries: counts and
    distinct counts exact, stddev and var rel REL_TOL, percentiles rel 0.06,
    approx_distinct rel HLL_REL; the select as a multiset."""
    if qname in SERVER_QUERIES:
        check_against_oracle(qname, records, want[qname], where)
        return
    if qname == "select_filter":
        got = sorted((r["host"], r["path"], r["status"], r["latency_ms"]) for r in records)
        check(len(got) == len(want[qname]),
              f"{where} {qname}: {len(got)} rows, oracle {len(want[qname])}")
        check(all(a[:3] == b[:3] and close(a[3], b[3]) for a, b in zip(got, want[qname])),
              f"{where} {qname}: rows differ from the oracle")
        return
    rel = {**STATS_REL, "hosts": HLL_REL}
    check(len(records) == len(want[qname]), f"{where} {qname}: {len(records)} groups")
    for r in records:
        key = (float(r["status"]),)
        check(key in want[qname], f"{where} {qname}: group {key} not in the oracle")
        for col, v in want[qname][key].items():
            tol = rel.get(col)
            ok = r[col] == v if tol is None else abs(r[col] - v) <= ABS_TOL + tol * abs(v)
            check(ok, f"{where} {qname} {key}.{col}: {r[col]} vs oracle {v}")


def check_cluster_query(qname: str, out: dict, settings: dict, want: dict, where: str) -> None:
    """One phase 13 answer against the oracle, and its path: a pushed-down
    GROUP BY reached every ingestor over the querier's tier with no
    fallback and moved no raw staging row; any other query pulled the
    staging windows and kept every block on the card."""
    st = out["stats"]
    fan = st["stages"]["fanout"]
    check(st["scan_errors"] == 0, f"{where} {qname}: scan errors")
    check_cluster_answer(qname, out["records"], want, where)
    if settings["query_pushdown"] and qname in PUSHED:
        tier = "flight" if settings["flight_client"] else "http"
        check(fan["mode"] == "pushdown" and fan["ok"] == CLUSTER_INGESTORS
              and fan["fallback"] == 0 and fan["fanin_bytes"] == 0
              and fan["transport"] == {tier: CLUSTER_INGESTORS}, f"{where} {qname}: fanout {fan}")
        return
    routes = st["device_routes"]
    check(fan["mode"] == "central" and fan["fanin_bytes"] > 0 and fan["fanin_errors"] == 0,
          f"{where} {qname}: fanout {fan}")
    if settings["flight_client"]:
        check(fan["transport"].get("flight_peers") == CLUSTER_INGESTORS,
              f"{where} {qname}: fan-in tiers {fan['transport']}")
    check(routes["cpu_fallback"] == 0, f"{where} {qname}: routes {routes}")
    check(routes["device_cold"] + routes["device_warm"] > 0,
          f"{where} {qname}: no block on the device {routes}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ingestor:
    """`P_MODE=ingest python -m parseable_tpu_torch.server`: the normal entry
    point, with its own staging dir, HTTP port and Flight port, on the
    shared store. Its sync ticks are an hour apart: a stop (SIGTERM: flush,
    convert, upload) is what moves its staging into the lake."""

    def __init__(self, work: Path, i: int):
        import os

        self.log = work / f"ingestor-{i}.log"
        self.port, self.flight_port = free_port(), free_port()
        self.env = {**os.environ, "P_MODE": "ingest", "P_ADDR": f"127.0.0.1:{self.port}",
                    "P_STAGING_DIR": str(work / f"staging-{i}"), "P_FS_DIR": str(work / "data"),
                    "P_FLIGHT_PORT": str(self.flight_port), "P_LOCAL_SYNC_INTERVAL": "3600",
                    "P_STORAGE_UPLOAD_INTERVAL": "3600"}
        self.proc = None

    def start(self) -> None:
        with open(self.log, "ab") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "parseable_tpu_torch.server"], cwd=ROOT, env=self.env,
                stdout=out, stderr=subprocess.STDOUT,
            )

    def wait_live(self, t0: float) -> None:
        import urllib.request

        while time.perf_counter() - t0 < 180 and self.proc.poll() is None:
            try:
                url = f"http://127.0.0.1:{self.port}/api/v1/liveness"
                with urllib.request.urlopen(url, timeout=5) as r:
                    if r.status == 200:
                        return
            except OSError:
                pass
            time.sleep(0.25)
        fail(f"ingestor on {self.port} never answered liveness (exit {self.proc.poll()}): "
             f"{self.log.read_text()[-3000:]}")

    def stop(self) -> int:
        import signal

        self.proc.send_signal(signal.SIGTERM)
        code = self.proc.wait(timeout=300)
        self.proc = None
        return code

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def drive_cluster(torch, seed: int, n_events: int = N_EVENTS, device=None) -> dict:
    """Phase 13: the cluster data plane. Two ingest-mode servers run as
    subprocesses through the normal entry point, each with its own staging
    dir and Flight port; one query-mode server runs here on the card; all
    three share one LocalFS store. Each ingestor acks `n_events` events of
    `make_events`' profile, half of them moved into the lake (a stop and a
    start) before the other half arrives, which stays in staging. The
    querier answers CLUSTER_QUERIES over HTTP, twice each, three ways
    (CLUSTER_MODES): pushed down over Flight, pushed down over HTTP, and
    central, the last with one more profiled status query for the device's
    idle share (on the card). Returns the kernels' launch counts of the
    phase. `device` as in `drive_main_path`."""
    import numpy as np

    from parseable_tpu_torch.config import Mode, Options, StorageOptions
    from parseable_tpu_torch.server.app import start_server

    work = ROOT / "build" / "smoke_cluster"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    on_card = device is None
    ingestors = [Ingestor(work, i) for i in range(CLUSTER_INGESTORS)]
    server = None
    try:
        t = time.perf_counter()
        for ing in ingestors:
            ing.start()
        rng = np.random.default_rng(seed + 13)
        per_node = [make_events(np, rng, n_events) for _ in ingestors]
        cols = {k: np.concatenate([c[k] for c in per_node]) for k in per_node[0]}
        want = cluster_oracle(np, cols)
        bodies = [request_bodies(c, EVENTS_PER_REQUEST) for c in per_node]
        for ing in ingestors:
            ing.wait_live(t)
        log(f"phase 13 ingestors: {CLUSTER_INGESTORS} live in {time.perf_counter() - t:.2f} s "
            f"(ports {[(i.port, i.flight_port) for i in ingestors]})")
        half = len(bodies[0]) // 2
        acked = 0
        for part in ("lake", "staging"):
            for ing, bs in zip(ingestors, bodies):
                some = bs[:half] if part == "lake" else bs[half:]
                n, lat, wall = send_events(ing.port, some, CLIENTS)
                acked += n
                log(f"phase 13 ingest ({part}): {n} events acked by :{ing.port} in {wall:.3f} s "
                    f"= {n / wall:.6g} rows/s, ack p99 "
                    f"{np.percentile(np.array(lat) * 1e3, 99):.3f} ms")
            if part == "lake":
                t = time.perf_counter()
                codes = [ing.stop() for ing in ingestors]
                check(codes == [0] * len(ingestors), f"ingestors exited {codes} on stop")
                stopped = time.perf_counter()
                for ing in ingestors:
                    ing.start()
                for ing in ingestors:
                    ing.wait_live(stopped)
                log(f"phase 13 sync: stop (flush, convert, upload) {stopped - t:.3f} s, start "
                    f"{time.perf_counter() - stopped:.3f} s")
        check(acked == n_events * len(ingestors), f"{acked} events acked")
        counts = kernel_counters()
        reset_launches(counts)
        walls: dict[str, dict] = {}
        for mode, settings in CLUSTER_MODES.items():
            opts = Options()
            opts.mode = Mode.QUERY
            opts.address = "127.0.0.1:0"
            opts.local_staging_path = work / "staging-q"
            opts.query_engine = "gpu"
            opts.query_result_cache_bytes = 0
            for k, v in settings.items():
                setattr(opts, k, v)
            server = start_server(opts, StorageOptions(root=work / "data"), device)
            for qname, sql in CLUSTER_QUERIES.items():
                before = launch_counts(counts)
                for run in ("first", "again"):
                    out, wall = http_query(server.port, sql.format(stream=STREAM))
                    walls.setdefault(mode, {}).setdefault(qname, {})[run] = wall
                    check_cluster_query(qname, out, settings, want, f"phase 13 {mode} {run}")
                delta = {k: v - before[k] for k, v in launch_counts(counts).items()}
                st = out["stats"]
                log(f"phase 13 {mode} {qname}: == oracle, HTTP walls "
                    f"{json.dumps(walls[mode][qname])} s, {st['rows_scanned']} rows scanned "
                    f"({st['staging_rows']} from staging), stages {json.dumps(st['stages'])}, "
                    f"launches {delta}")
            if on_card and not settings["query_pushdown"]:
                profile_idle(torch, server.port, "status", f"phase 13 {mode}")
            server.stop()
            server = None
        launches = launch_counts(counts)
        log(f"phase 13 launches on the querier's central path: {launches}")
        log("phase 13 HTTP query wall s: " + json.dumps(walls))
        if on_card:
            for name in ("mask_ids", "stack_operands", "additive_groupby", "minmax_groupby",
                         "distinct_fold", "pct_histogram", "centered_m2"):
                check(launches[name] > 0, f"{name} was never launched in phase 13")
        t = time.perf_counter()
        codes = [ing.stop() for ing in ingestors]
        check(codes == [0] * len(ingestors), f"ingestors exited {codes} on stop")
        log(f"phase 13 stop: ingestors drained and exited 0 in {time.perf_counter() - t:.3f} s")
        return launches
    finally:
        if server is not None:
            server.stop()
        for ing in ingestors:
            ing.kill()
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42, help="seed of the lake's data")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from parseable_tpu_torch import native
        from parseable_tpu_torch.ops import cuda_lib
        from parseable_tpu_torch.ops import fold_cuda as F
        from parseable_tpu_torch.ops import groupby_cuda as G
        from parseable_tpu_torch.ops import mesh_cuda as MC
        from parseable_tpu_torch.ops import stats_cuda as SC
        from parseable_tpu_torch.ops import topk_cuda as K
        from parseable_tpu_torch.ops.enccache import shutdown_enccache
        from parseable_tpu_torch.ops.hotset import get_hotset
        from parseable_tpu_torch.utils.devicecheck import probe
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds: dict[str, float] = {}
    clock = [time.perf_counter()]

    def phase_done(name: str) -> None:
        # (the timer exists from phase 1 on)
        log(f"phase {name}: timer windows re-run {timer.reruns}, never ahead of the device "
            f"{timer.dry}")
        timer.reruns = timer.dry = 0
        now = time.perf_counter()
        seconds[name] = round(now - clock[0], 3)
        clock[0] = now

    # -- phase 1: device and build (one nvcc per source, started together)
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    report = probe("cuda")
    check(report.get("healthy") is True, f"device probe failed: {report}")
    log(f"phase 1 device: {report}")
    # the native ingest library (g++) builds beside the kernels (nvcc)
    from concurrent.futures import ThreadPoolExecutor

    def load_native() -> float:
        t = time.perf_counter()
        native.load()
        return time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=1) as pool:
        native_built = pool.submit(load_native)
        built = cuda_lib.build_all([G.LIBRARY, SC.LIBRARY, F.LIBRARY, K.LIBRARY, MC.LIBRARY])
        native_s = native_built.result()
    log(f"phase 1 build: kernels built and loaded in {built:.3f} s, the native ingest "
        f"library in {native_s:.3f} s ({native.library_path().name})")
    timer = DeviceTimer(torch)
    phase_done("1 device and build")

    # -- phase 2: every regime of every kernel against its plain version,
    # on uniform inputs at the shapes the main path does not use, then the
    # edge cases in every regime
    gen = torch.Generator().manual_seed(args.seed)
    for r, g, regime in ((5, 128, "tensor"), (5, 2048, "shared"), (5, 65536, "global")):
        res = kernel_a_case(torch, G, timer, *uniform_a(torch, r, N_BLOCK, g, gen), g,
                            "uniform", regime=regime)
        log(f"phase 2 additive_groupby {json.dumps(res)}")
    for g in (128, 2048, 8192, 65536):
        res = kernel_b_case(torch, G, timer, *uniform_b(torch, 2, N_BLOCK, g, gen), g, 1,
                            "uniform")
        log(f"phase 2 minmax_groupby {json.dumps(res)}")
    for kind, key, regime in STATS_REGIMES:
        old = whole_copy_regime(SC, kind, key)
        turns = (regime, old, old, regime) if kind == "centered_m2" and regime != old else ()
        res = stats_case(torch, SC, timer, kind, key, stats_inputs(torch, SC, kind, key, gen),
                         "uniform", regime=regime, turns=turns)
        log(f"phase 2 {kind} {json.dumps(res)}")
    # the block-local fold's group counts: A "global", B's decode launch, K7
    # "global", which the dense path never reaches past 65,536 groups
    for g in (1 << 17, 1 << 20, 1 << 22):
        for r in (3, 4):
            res = kernel_a_case(torch, G, timer, *uniform_a(torch, r, N_BLOCK, g, gen), g,
                                "uniform")
            check(res["regime"] == "global", f"kernel A at G={g}: {res['regime']}")
            log(f"phase 2 additive_groupby (local fold) {json.dumps(res)}")
        res = kernel_b_case(torch, G, timer, *uniform_b(torch, 2, N_BLOCK, g, gen), g, 1, "uniform")
        check(res["decode"] == "launch", f"kernel B at G={g}: decode {res['decode']}")
        log(f"phase 2 minmax_groupby (local fold) {json.dumps(res)}")
        key = (1, N_BLOCK, g)
        res = stats_case(torch, SC, timer, "centered_m2", key,
                         stats_inputs(torch, SC, "centered_m2", key, gen), "uniform")
        check(res["regime"] == "global", f"K7 at G={g}: {res['regime']}")
        log(f"phase 2 centered_m2 (local fold) {json.dumps(res)}")
    local_fold_hazards(torch, G, SC, gen)
    edge_cases(torch, G, gen)
    rule_sweep(torch, G, timer, gen)
    k3_hazards(torch, F, timer, args.seed)
    phase_done("2 regimes, edges, rules")

    # -- phase 9: ROADMAP list 3's repaired wrong answers, on the card
    drive_list3()
    phase_done("9 list 3 repros")

    # -- phases 3, 4, 7 and 8: the lake, then the main path and the
    # statistics queries on it in every cache state, then the hot set under
    # pressure
    work = ROOT / "build" / "smoke_lake"
    shutil.rmtree(work, ignore_errors=True)
    p = None
    try:
        p = build_lake(work, args.seed, MINUTES, N_BLOCK)
        phase_done("3 lake")
        launches, shapes, inputs, k3_main, k8_main = drive_main_path(p)
        phase_done("4 main path")
        stats_launches, stats_shapes, stats_inputs_, k3_stats = drive_stats(p)
        phase_done("7 statistics")
        pressure_launches = drive_pressure(torch, p)
        phase_done("8 hot-set pressure")
        # -- phase 11 on the phase 3 lake: a degraded link, then the result cache
        counts = kernel_counters()
        reset_launches(counts)
        gate = gate_runs(torch, p, [
            ("groupby", QUERIES["groupby"].format(stream=STREAM), same_result),
            ("select_filter", SELECT_QUERIES["select_filter"][0].format(stream=STREAM),
             lambda n, g, c: same_select(n, g, c, SELECT_QUERIES["select_filter"][1])),
        ], "phase 11")
        gate["result_cache"] = result_cache_runs(torch, p)
        log(f"phase 11 launches: {launch_counts(counts)}")
        log_residency(torch, "phase 11", True)
        phase_done("11 gate and result cache")
        # -- phase 12 on the phase 3 lake: the same queries under a mesh
        check(MC.LAUNCHES["mesh_combine"] == 0, "K10 launched before phase 12")
        reset_launches(counts)
        with K10Recorder(MC) as k10_rec:
            mesh_runs(torch, p, mesh_queries(), "phase 12")
        mesh_launches = launch_counts(counts)
        check(mesh_launches["mesh_combine"] > 0, "K10 never launched in phase 12")
        log(f"phase 12 (query lake) launches: {mesh_launches}")
        log_residency(torch, "phase 12", True)
        phase_done("12 mesh, query lake")
    finally:
        if p is not None:
            p.shutdown()
        get_hotset().clear()  # the lake's blocks leave the card
        shutdown_enccache()
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 10: high cardinality, on a lake of its own
    hc_mesh: dict = {}

    def hc_mesh_runs(hc_lake) -> None:
        # phase 12 on the high-cardinality lake: hc_minute_path (local
        # mode) under 4 shards, device-warm
        sql, keys, _ = HC_QUERIES["hc_minute_path"]
        reset_launches(counts)
        with K10Recorder(MC) as rec:
            mesh_runs(torch, hc_lake, [("hc_minute_path", sql.format(stream=HC_STREAM),
                                        lambda n, g, c: same_table(n, g, c, keys), None)],
                      "phase 12", states=("device-warm",), layouts=("4 ", "2 cards", "4 cards"))
        hc_mesh.update(launches=launch_counts(counts), calls=rec.calls)
        log(f"phase 12 (highcard lake) launches: {hc_mesh['launches']}")

    hc_launches, k8_case, k3_hc, hc_calls, hc_gate = drive_highcard(torch, args.seed, timer,
                                                                    then=hc_mesh_runs)
    gate.update(hc_gate)
    check(hc_launches["mesh_combine"] == 0, f"K10 launched in phase 10: {hc_launches}")
    # K8 on topk_multicol's own accumulator from phase 4, beside hc_topk_path's
    k8_multicol = topk_case(torch, K, timer, *k8_main, "main path, phase 4")
    log(f"phase 10 topk_groups (topk_multicol) {json.dumps(k8_multicol)}")
    # K8 kernels a call, from the profiled runs of phases 4 and 10 (one K8
    # call a query): one in the block regime, which both queries take (a
    # record the profiler drops lowers the count, none raises it; None if it
    # kept none)
    k8_launches = max((r["kernels"] / r["calls"] for r in K8_PROFILED), default=0) or None
    check((k8_launches or 0) <= 1, f"K8 launches a call on the main path: {K8_PROFILED}")
    log(f"phase 10 K8 launches a call (profiled queries): {k8_launches} {json.dumps(K8_PROFILED)}")
    phase_done("10 high cardinality")

    # -- phase 12 on the card: K10 bit for bit on every shape the mesh runs
    # gave it and on the hazard set, then timed at the heaviest
    k10_calls = dict(k10_rec.calls)
    for shape, seen in hc_mesh["calls"].items():
        k10_calls.setdefault(shape, seen)
    k10, k10_cases = k10_checks(torch, MC, timer, args.seed, k10_calls)
    log(f"phase 12 K10 exact: {k10_cases} cases ({len(k10_calls)} of the phase's shapes, "
        f"{sum(c for _, c in k10_calls.values())} calls)")
    log(f"phase 12 mesh_combine {json.dumps(k10)}")
    for name in mesh_launches:
        mesh_launches[name] += hc_mesh["launches"][name]
    phase_done("12 mesh, high cardinality and K10")

    # -- phase 6: the HTTP server, ingest and queries, on the card
    server_launches = drive_server(torch, G, args.seed)
    phase_done("6 server")

    # -- phase 13: the cluster data plane, two ingestors and a querier
    cluster_launches = drive_cluster(torch, args.seed)
    phase_done("13 cluster")

    # -- phase 5: each kernel at the shapes the main path gave it, on one
    # block's real inputs (and kernels A and B on uniform inputs of the same
    # shape)
    import threading

    alive = [t.name for t in threading.enumerate()]
    log(f"phase 5 threads alive: {alive}")
    check("device-warmer" not in alive, "the device warmer outlived its phase")
    log(f"phase 11 walls ms: {json.dumps(gate)}")
    report = []
    replaces = {
        "additive_groupby": "parseable_tpu/ops/pallas_groupby.py:53",
        "minmax_groupby": "parseable_tpu/ops/kernels.py:233",
        "distinct_fold": "parseable_tpu/query/executor_tpu.py:2931",
        "pct_histogram": "parseable_tpu/query/executor_tpu.py:2954",
        "centered_m2": "parseable_tpu/query/executor_tpu.py:889",
        **dict.fromkeys(K3_KERNELS, "parseable_tpu/query/executor_tpu.py:2852"),
    }
    sources = {
        "additive_groupby": "parseable_tpu_torch/csrc/groupby.cu",
        "minmax_groupby": "parseable_tpu_torch/csrc/groupby.cu",
        **dict.fromkeys(STATS_KERNELS, "parseable_tpu_torch/csrc/stats.cu"),
        **dict.fromkeys(K3_KERNELS, "parseable_tpu_torch/csrc/fold.cu"),
    }
    by_phase = {"lake": launches, "stats": stats_launches, "server": server_launches,
                "pressure": pressure_launches, "highcard": hc_launches, "mesh": mesh_launches,
                "cluster": cluster_launches}

    def phase_launches(name: str) -> dict:
        # each phase's own count of the kernel's launches
        return {f"launches_{phase}": counted[name] for phase, counted in by_phase.items()}

    for name in ("additive_groupby", "minmax_groupby", *STATS_KERNELS, *K3_KERNELS):
        cases = []
        k3_recs = ((k3_main, "main path"), (k3_stats, "main path"), (k3_hc, "main path, phase 10"))
        for rec, kind in k3_recs if name in K3_KERNELS else ():
            # each phase-4/7/10 query's own block, on the inputs it gave the
            # kernel (the line reports phase 4 and 7's heaviest)
            for qname, data in rec.inputs[name].items():
                res = k3_case(torch, F, timer, name, data, kind)
                res["query"], res["main_path_calls"] = qname, rec.shapes[name][qname]
                log(f"phase 5 {name} {json.dumps(res)}")
                cases.append(res)
        if name in STATS_KERNELS:
            for key, calls in sorted(stats_shapes[name].items(), key=str):
                data = stats_inputs_[name][key]
                # the rule's pick against the whole-copy rule's, in turns, on the main
                # path's own inputs
                new, old = rule_regime(SC, name, key), whole_copy_regime(SC, name, key)
                turns = (new, old, old, new) if new != old else ()
                res = stats_case(torch, SC, timer, name, key, data, "main path", turns=turns)
                res["main_path_calls"] = calls
                log(f"phase 5 {name} {json.dumps(res)}")
                cases.append(res)
                if turns:
                    alt = stats_case(torch, SC, timer, name, key, data, "main path", regime=old)
                    log(f"phase 5 {name} (the whole-copy rule's regime) {json.dumps(alt)}")
        for key, calls in sorted(shapes.get(name, {}).items()):
            for kind in ("main path", "uniform"):
                if name == "additive_groupby":
                    r, n, g = key
                    data = inputs[name][key] if kind == "main path" else uniform_a(
                        torch, r, n, g, gen)
                    res = kernel_a_case(torch, G, timer, *data, g, kind)
                else:
                    k, n_min, n, g = key
                    data = inputs[name][key] if kind == "main path" else uniform_b(
                        torch, k, n, g, gen)
                    res = kernel_b_case(torch, G, timer, *data, g, n_min, kind)
                res["main_path_calls"] = calls
                log(f"phase 5 {name} {json.dumps(res)}")
                cases.append(res)
        for (qname, key), (data, calls) in hc_calls.get(name, {}).items():
            # each phase-10 query's first call at each shape, on its own inputs
            kind = "main path, phase 10"
            if name == "additive_groupby":
                res = kernel_a_case(torch, G, timer, *data, key[2], kind)
            elif name == "minmax_groupby":
                res = kernel_b_case(torch, G, timer, *data, key[3], key[1], kind)
            else:
                res = stats_case(torch, SC, timer, name, key, data, kind)
            res["query"], res["main_path_calls"] = qname, calls
            log(f"phase 5 {name} {json.dumps(res)}")
            cases.append(res)
        # the line reports the main path's heaviest shape, on its own inputs
        top = max((c for c in cases if c["inputs"] == "main path"), key=lambda c: c["bound_ms"])
        report.append(
            {
                "name": name,
                "route": "cuda",
                "source": sources[name],
                "replaces": replaces[name],
                # phase 4's count for A, B and K3, phase 7's for K5-K7
                "launches": stats_launches[name] if name in STATS_KERNELS else launches[name],
                **phase_launches(name),
                "max_abs_err": top["max_abs_err"],
                "ms": top["ms"],
                "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"],
                "library_ms": top["library_ms"],
                "shape": top["shape"],
                "regime": top["regime"],
                "inputs": "main path, L2-cold",
                "ms_l2_warm": top["ms_l2_warm"],
                "profiler_ms": top["profiler_ms"],
                "sum_ms": top["sum_ms"],
            }
        )
    # K8: timed in phase 10 on hc_topk_path's own accumulator (and on
    # topk_multicol's from phase 4); its launches are phase 4's (topk_multicol)
    report.append(
        {
            "name": "topk_groups",
            "route": "cuda",
            "source": "parseable_tpu_torch/csrc/topk.cu",
            "replaces": "parseable_tpu/query/executor_tpu.py:2165",
            "launches": launches["topk_groups"],
            **phase_launches("topk_groups"),
            **{k: k8_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape", "regime", "ms_l2_warm",
                                       "profiler_ms", "sum_ms")},
            "inputs": "main path (phase 10 hc_topk_path), L2-cold",
            "launches_per_call": k8_launches,
            "topk_multicol": {k: k8_multicol[k] for k in ("shape", "regime", "ms", "plain_ms",
                                                           "bound_ms", "library_ms")},
        }
    )
    # K10: its launches and time from phase 12, the mesh's path
    report.append(
        {
            "name": "mesh_combine",
            "route": "cuda",
            "source": "parseable_tpu_torch/csrc/mesh.cu",
            "replaces": "parseable_tpu/parallel/mesh.py:91",
            "launches": mesh_launches["mesh_combine"],
            **phase_launches("mesh_combine"),
            **{k: k10[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "shape", "regime", "ms_l2_warm", "profiler_ms",
                                   "sum_ms")},
            "inputs": "main path (phase 12), L2-cold",
        }
    )
    phase_done("5 kernel times")
    # the work dirs are gone, and nothing the run did (phase 5's executors
    # are built without options) rooted a link profile or an encoded-block
    # cache anywhere else under the checkout
    from parseable_tpu_torch.ops.link import get_link

    get_link().flush()
    left = sorted(str(f) for name in ("link_profile.json", "encoded_cache")
                  for f in ROOT.rglob(name))
    check(not left, f"state outlived the work dirs: {left}")
    log(f"seconds per phase: {json.dumps(seconds)}")
    log(smi)  # the card, as nvidia-smi names it and its power limit
    print(json.dumps({"kernels": report}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
