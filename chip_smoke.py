#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 42]

Builds the hand-written group-by kernels from `parseable_tpu_torch/csrc/`,
holds each against its plain PyTorch version on the card, writes an access-
log lake of 2^23 rows (8 one-minute Parquet files of 2^20 rows, the shape of
`bench.py`'s "default" profile) through the port's own sync path, and
answers four GROUP BY queries on the port's "gpu" engine and on its "cpu"
engine, cold and then warm. Any failed check raises, so the script exits
non-zero; it needs one CUDA card and has no CPU path.

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
import statistics
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
REL_TOL = 2e-4  # f32 sums against f64 (tests/test_engine_fuzz.py model)
ABS_TOL = 1e-6

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
BASE = datetime(2024, 5, 1, 0, 0, tzinfo=UTC)


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


def cuda_ms(torch, fn, iters: int = 15, warmup: int = 3) -> float:
    """Median device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations over
    the f32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


# ---------------------------------------------------------------- kernels


def kernel_a_case(torch, G, r: int, n: int, g: int, gen) -> dict:
    """Kernel A vs its plain version and a float64 host sum at [r, n] -> [r, g]."""
    dev = torch.device("cuda")
    ids = torch.randint(0, g, (n,), generator=gen, dtype=torch.int32)
    mask = torch.rand(n, generator=gen) < 0.9
    # rows as the main path builds them: row mask, 0/1 validity, masked sums
    n_valid = (r - 1) // 2
    rows = torch.cat(
        [
            mask[None].float(),
            (torch.rand(n_valid, n, generator=gen) < 0.8).float() * mask[None],
            torch.rand(r - 1 - n_valid, n, generator=gen) * 50_000 * mask[None],
        ]
    )
    ref64 = torch.zeros(r, g, dtype=torch.float64).index_add_(1, ids.long(), rows.double())
    ids_d, rows_d = ids.to(dev), rows.to(dev).contiguous()
    out = G.additive_groupby(ids_d, rows_d, g)
    plain = G.additive_groupby_plain(ids_d, rows_d, g)
    torch.cuda.synchronize()
    out_h = out.double().cpu()
    counts = 1 + n_valid
    check(torch.equal(out_h[:counts], ref64[:counts]), f"kernel A counts not exact at R={r} G={g}")
    rel = ((out_h - ref64).abs() / ref64.abs().clamp_min(1.0)).max().item()
    check(rel <= REL_TOL, f"kernel A sums rel err {rel} > {REL_TOL} at R={r} G={g}")
    err = (out - plain).abs().max().item()
    check(
        bool(torch.allclose(out, plain, rtol=REL_TOL, atol=ABS_TOL)),
        f"kernel A disagrees with its plain version at R={r} G={g}: {err}",
    )
    lib_out = torch.zeros(r, g, device=dev)
    ms = cuda_ms(torch, lambda: G.additive_groupby(ids_d, rows_d, g))
    plain_ms = cuda_ms(torch, lambda: G.additive_groupby_plain(ids_d, rows_d, g))
    library_ms = cuda_ms(torch, lambda: lib_out.index_add_(1, ids_d, rows_d))
    b, by = bound_ms(4 * n * (r + 1) + 4 * r * g, r * n)
    return {
        "shape": f"R={r} N={n} G={g}", "regime": "shared" if r * g * 4 <= 200 * 1024 else "global",
        "max_abs_err": err, "max_rel_err_f64": rel, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b, "bound_by": by, "library_ms": library_ms,
    }


def kernel_b_case(torch, G, k: int, n_min: int, n: int, g: int, gen) -> dict:
    """Kernel B vs its plain version at [k, n] -> [k, g], exact."""
    dev = torch.device("cuda")
    # a quarter of the groups get no row: their identities (+-inf) must show
    ids = torch.randint(0, max(1, (3 * g) // 4), (n,), generator=gen, dtype=torch.int32)
    mask = torch.rand(n, generator=gen) < 0.9
    vals = torch.randn(k, n, generator=gen) * 1000
    valid = torch.rand(k, n, generator=gen) < 0.8
    ids_d, vals_d, valid_d, mask_d = (t.to(dev).contiguous() for t in (ids, vals, valid, mask))
    mn, mx = G.minmax_groupby(ids_d, vals_d, valid_d, mask_d, g, n_min)
    pmn, pmx = G.minmax_groupby_plain(ids_d, vals_d, valid_d, mask_d, g, n_min)
    torch.cuda.synchronize()
    check(torch.equal(mn, pmn) and torch.equal(mx, pmx), f"kernel B not exact at K={k} G={g}")
    both = torch.cat([mn, mx]), torch.cat([pmn, pmx])
    finite = torch.isfinite(both[1])
    err = (both[0][finite] - both[1][finite]).abs().max().item() if finite.any() else 0.0
    live = valid_d & mask_d[None]
    idx = ids_d.long()[None].expand(k, n)
    lo = torch.where(live[:n_min], vals_d[:n_min], 3.4e38)
    hi = torch.where(live[n_min:], vals_d[n_min:], -3.4e38)
    lib_mn = torch.full((n_min, g), math.inf, device=dev)
    lib_mx = torch.full((k - n_min, g), -math.inf, device=dev)

    def library():
        lib_mn.scatter_reduce_(1, idx[:n_min], lo, reduce="amin", include_self=True)
        lib_mx.scatter_reduce_(1, idx[n_min:], hi, reduce="amax", include_self=True)

    ms = cuda_ms(torch, lambda: G.minmax_groupby(ids_d, vals_d, valid_d, mask_d, g, n_min))
    plain_ms = cuda_ms(
        torch, lambda: G.minmax_groupby_plain(ids_d, vals_d, valid_d, mask_d, g, n_min)
    )
    library_ms = cuda_ms(torch, library)
    b, by = bound_ms(n * (4 + 5 * k + 1) + 4 * k * g, k * n)
    return {
        "shape": f"K={k} n_min={n_min} N={n} G={g}",
        "regime": "shared" if k * g * 4 <= 200 * 1024 else "global",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
        "library_ms": library_ms,
    }


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


def same_result(name: str, gpu, cpu) -> None:
    a, b = rows_of(gpu), rows_of(cpu)
    check(len(a) == len(b), f"{name}: {len(a)} rows on gpu vs {len(b)} on cpu")
    for ra, rb in zip(a, b):
        check(ra.keys() == rb.keys(), f"{name}: columns differ")
        for col in ra:
            va, vb = ra[col], rb[col]
            if isinstance(va, float) and isinstance(vb, float):
                check(
                    abs(va - vb) <= ABS_TOL + REL_TOL * abs(vb),
                    f"{name}.{col}: gpu {va} vs cpu {vb}",
                )
            else:
                check(va == vb, f"{name}.{col}: gpu {va!r} vs cpu {vb!r}")


def build_lake(work: Path, seed: int, minutes: int, rows: int):
    """Phase 3: stage one Parquet file per minute and sync it into the lake
    through the port's own upload and catalog commit."""
    import numpy as np
    import pyarrow as pa

    from parseable_tpu_torch.config import Options, StorageOptions
    from parseable_tpu_torch.core import Parseable

    t0 = time.perf_counter()
    opts = Options()
    opts.local_staging_path = work / "staging"
    p = Parseable(opts, StorageOptions(root=work / "data"))
    stream = p.create_stream_if_not_exists(STREAM)
    rng = np.random.default_rng(seed)
    for minute in range(minutes):
        stream.write_parquet(make_minute(pa, np, rng, minute, rows), BASE + timedelta(minutes=minute))
    p.sync_all_streams()
    fmt = p.metastore.get_stream_json(STREAM)
    check(fmt.stats.events == minutes * rows, f"lake holds {fmt.stats.events} rows")
    check(not stream.parquet_files(), "staged parquet left after sync")
    log(
        f"phase 3 lake: {fmt.stats.events} rows in {minutes} files, "
        f"{fmt.stats.storage} parquet bytes, {time.perf_counter() - t0:.2f} s"
    )
    return p


def profiled_query(torch, sess, qname: str, text: str):
    """One more warm GPU run under torch.profiler: the device's busy time
    (CUDA kernels and copies) against the query's wall time, and the two
    hand kernels' share of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = sess.query(text)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy_us = {"all": 0.0, "additive": 0.0, "minmax": 0.0}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", 0.0)
            busy_us["all"] += us
            for k in ("additive", "minmax"):
                if k in ev.key:
                    busy_us[k] += us
    if busy_us["all"] == 0.0:
        log(f"phase 4 {qname} profile: the profiler saw no device time (not measured)")
    else:
        log(
            f"phase 4 {qname} profile: wall {wall_ms:.3f} ms, device busy "
            f"{busy_us['all'] / 1e3:.3f} ms (idle share {1 - busy_us['all'] / 1e3 / wall_ms:.4f}), "
            f"kernel A {busy_us['additive'] / 1e3:.3f} ms, kernel B {busy_us['minmax'] / 1e3:.3f} ms"
        )
    return res


def drive_main_path(p, device=None) -> tuple[dict, dict]:
    """Phase 4: every query on the "gpu" engine (on `device`, default the
    card) and the "cpu" engine, cold then warm; the engines must agree, the
    GPU runs must stay on the device and launch the kernels. Returns the
    launch counts of the run and the kernel shapes it used."""
    import torch

    from parseable_tpu_torch.ops import groupby_cuda as G
    from parseable_tpu_torch.ops import kernels as K
    from parseable_tpu_torch.query.session import QuerySession

    shapes: dict[str, dict] = {"additive_groupby": {}, "minmax_groupby": {}}
    real_a, real_b = K.additive_groupby, K.minmax_groupby

    def rec_a(ids, rows, g):
        key = (rows.shape[0], rows.shape[1], g)
        shapes["additive_groupby"][key] = shapes["additive_groupby"].get(key, 0) + 1
        return real_a(ids, rows, g)

    def rec_b(ids, vals, valid, mask, g, n_min):
        key = (vals.shape[0], n_min, vals.shape[1], g)
        shapes["minmax_groupby"][key] = shapes["minmax_groupby"].get(key, 0) + 1
        return real_b(ids, vals, valid, mask, g, n_min)

    on_card = device is None or torch.device(device).type == "cuda"
    K.additive_groupby, K.minmax_groupby = rec_a, rec_b
    for name in G.LAUNCHES:
        G.LAUNCHES[name] = 0
    per_query: dict[str, dict] = {}
    try:
        for qname, sql in QUERIES.items():
            text = sql.format(stream=STREAM)
            before = dict(G.LAUNCHES)
            out: dict[str, list] = {}
            for engine in ("gpu", "cpu"):
                for run in ("cold", "warm"):
                    sess = QuerySession(p, engine=engine, device=device if engine == "gpu" else None)
                    t = time.perf_counter()
                    res = sess.query(text)
                    if engine == "gpu" and on_card:
                        torch.cuda.synchronize()
                    dt = time.perf_counter() - t
                    out.setdefault(engine, []).append(res)
                    rows_s = res.stats["rows_scanned"] / dt
                    log(
                        f"phase 4 {qname} {engine} {run}: {res.table.num_rows} rows out, "
                        f"{res.stats['rows_scanned']} scanned in {dt:.3f} s = {rows_s:.6g} rows/s"
                        f" stages {res.stats['stages']}"
                        + (f" routes {res.stats['device_routes']}" if engine == "gpu" else "")
                    )
                    per_query.setdefault(qname, {})[f"{engine}_{run}_rows_per_s"] = rows_s
            if on_card:
                out["gpu"].append(profiled_query(torch, QuerySession(p, device=device), qname, text))
            for res in out["gpu"]:
                routes = res.stats["device_routes"]
                check(routes["cpu_fallback"] == 0, f"{qname}: cpu_fallback {routes}")
                check(routes["device_cold"] > 0, f"{qname}: no block ran on the device {routes}")
                check(res.stats["scan_errors"] == 0, f"{qname}: scan errors")
            for res in out["gpu"] + out["cpu"][1:]:
                same_result(qname, res.table, out["cpu"][0].table)
            check(out["gpu"][0].table.num_rows > 0, f"{qname}: empty result")
            delta = {k: G.LAUNCHES[k] - before[k] for k in G.LAUNCHES}
            if on_card:
                check(delta["additive_groupby"] > 0, f"{qname}: kernel A never launched")
                if qname == "minmax":
                    check(delta["minmax_groupby"] > 0, f"{qname}: kernel B never launched")
            log(f"phase 4 {qname}: gpu == cpu, launches {delta}")
    finally:
        K.additive_groupby, K.minmax_groupby = real_a, real_b
    launches = dict(G.LAUNCHES)
    if on_card:
        for name, n in launches.items():
            check(n > 0, f"{name} was never launched on the main path")
    log(f"phase 4 launches on the main path: {launches}")
    log(f"phase 4 rows/s: {json.dumps(per_query)}")
    return launches, shapes



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
        from parseable_tpu_torch.ops import groupby_cuda as G
        from parseable_tpu_torch.utils.devicecheck import probe
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: device and build
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    report = probe("cuda")
    check(report.get("healthy") is True, f"device probe failed: {report}")
    log(f"phase 1 device: {report}")
    log(f"phase 1 build: kernels built and loaded in {G.build_and_load():.3f} s")

    # -- phase 2: both kernels in both regimes, against their plain versions
    gen = torch.Generator().manual_seed(args.seed)
    for g in (128, 2048, 65536):
        res = kernel_a_case(torch, G, 5, N_BLOCK, g, gen)
        log(f"phase 2 additive_groupby {json.dumps(res)}")
        res = kernel_b_case(torch, G, 2, 1, N_BLOCK, g, gen)
        log(f"phase 2 minmax_groupby {json.dumps(res)}")

    # -- phases 3 and 4: the lake, then the main path on it
    work = ROOT / "build" / "smoke_lake"
    shutil.rmtree(work, ignore_errors=True)
    try:
        p = build_lake(work, args.seed, MINUTES, N_BLOCK)
        launches, shapes = drive_main_path(p)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 5: each kernel at the shapes the main path gave it
    report = []
    replaces = {
        "additive_groupby": "parseable_tpu/ops/pallas_groupby.py:53",
        "minmax_groupby": "parseable_tpu/ops/kernels.py:233",
    }
    for name in ("additive_groupby", "minmax_groupby"):
        cases = []
        for key, calls in sorted(shapes[name].items()):
            if name == "additive_groupby":
                r, n, g = key
                res = kernel_a_case(torch, G, r, n, g, gen)
            else:
                k, n_min, n, g = key
                res = kernel_b_case(torch, G, k, n_min, n, g, gen)
            res["main_path_calls"] = calls
            log(f"phase 5 {name} {json.dumps(res)}")
            cases.append(res)
        # the line reports the main path's heaviest shape
        top = max(cases, key=lambda c: c["bound_ms"])
        report.append(
            {
                "name": name,
                "route": "cuda",
                "source": "parseable_tpu_torch/csrc/groupby.cu",
                "replaces": replaces[name],
                "launches": launches[name],
                "max_abs_err": top["max_abs_err"],
                "ms": top["ms"],
                "plain_ms": top["plain_ms"],
                "bound_ms": top["bound_ms"],
                "bound_by": top["bound_by"],
                "library_ms": top["library_ms"],
                "shape": top["shape"],
            }
        )
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
