"""The port and the JAX package on one lake, both ways, on the CPU.

- The JAX `Parseable` builds a lake the way `bench.build_dataset` does
  (ingest -> staging -> parquet -> object store -> catalog); the port opens
  it and answers the same SQL as the JAX `QuerySession` on its "tpu" and
  "cpu" engines.
- The port stages Parquet and commits it with its own `sync_all_streams`;
  the JAX package opens that lake and answers the same SQL the same way.

Tolerances as in tests/test_torch_executor.py: counts and keys exact, every
float (sums, averages, min/max against f64 engines) rel 2e-4, abs 1e-6.
The port's GPU engine runs with `device="cpu"` (its kernels' plain
versions); without that argument it needs a card, and raises without one.
"""

import subprocess
import sys
from datetime import UTC, datetime, timedelta
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import bench
from parseable_tpu.config import Options as JaxOptions
from parseable_tpu.config import StorageOptions as JaxStorageOptions
from parseable_tpu.core import Parseable as JaxParseable
from parseable_tpu.query.session import QuerySession as JaxSession
from parseable_tpu_torch.config import Options, StorageOptions
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.query.session import QuerySession
from parseable_tpu_torch.utils.devicecheck import DeviceUnavailable

TOL = dict(rel=2e-4, abs=1e-6)
STREAM = "weblogs"
QUERIES = [
    bench.CONFIGS["groupby"].format(stream=STREAM),
    bench.CONFIGS["regex_filter"].format(stream=STREAM),
    bench.CONFIGS["topk_multicol"].format(stream=STREAM),
    f"SELECT host, min(latency_ms) AS mn, max(bytes) AS mx FROM {STREAM} "
    "WHERE status >= 400 AND p_timestamp >= '2024-05-01T00:00:30Z' GROUP BY host",
]
KEYS = ("t", "status", "path", "host")


def rows(table: pa.Table) -> list[dict]:
    keys = [c for c in table.column_names if c in KEYS]
    return sorted(table.to_pylist(), key=lambda r: tuple(str(r[k]) for k in keys))


def assert_same(ref: pa.Table, got: pa.Table, sql: str) -> None:
    a, b = rows(ref), rows(got)
    assert len(a) == len(b) and a, (sql, len(a), len(b))
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys(), sql
        for k, va in ra.items():
            vb = rb[k]
            if isinstance(va, float) and isinstance(vb, float):
                assert vb == pytest.approx(va, **TOL), (sql, k, va, vb)
            else:
                assert va == vb, (sql, k, va, vb)


def port_at(root, staging) -> Parseable:
    opts = Options()
    opts.local_staging_path = staging
    return Parseable(opts, StorageOptions(root=root))


def check_port_answers(port: Parseable, refs: dict) -> None:
    for sql in QUERIES:
        gpu = QuerySession(port, engine="gpu", device="cpu").query(sql)
        routes = gpu.stats["device_routes"]
        assert routes["cpu_fallback"] == 0 and routes["device_cold"] > 0, (sql, routes)
        cpu = QuerySession(port, engine="cpu").query(sql)
        for ref in refs[sql]:
            assert_same(ref, gpu.table, sql)
            assert_same(ref, cpu.table, sql)


def test_port_reads_the_lake_the_jax_package_wrote(parseable, tmp_path):
    bench.build_dataset(parseable, STREAM, 20_000)
    refs = {
        sql: [JaxSession(parseable, engine=e).query(sql).table for e in ("tpu", "cpu")]
        for sql in QUERIES
    }
    check_port_answers(port_at(tmp_path / "data", tmp_path / "port_staging"), refs)


def test_jax_package_reads_the_lake_the_port_wrote(tmp_path):
    port = port_at(tmp_path / "data", tmp_path / "port_staging")
    stream = port.create_stream_if_not_exists(STREAM)
    rng = np.random.default_rng(42)
    n = 5000
    hosts = np.array([f"10.0.0.{i}" for i in range(8)])
    paths = np.array([f"/api/v1/resource{i}" for i in range(6)])
    messages = np.array(["request completed", "error: upstream timeout", "cache miss"])
    base = datetime(2024, 5, 1, tzinfo=UTC)
    for minute in range(3):
        offsets = np.sort(rng.integers(0, 60_000, n)).astype("timedelta64[ms]")
        start = np.datetime64("2024-05-01T00:00:00", "ms") + np.timedelta64(minute, "m")
        stream.write_parquet(
            pa.table(
                {
                    "p_timestamp": pa.array(start + offsets, pa.timestamp("ms")),
                    "host": pa.array(hosts[rng.integers(0, len(hosts), n)]),
                    "path": pa.array(paths[rng.integers(0, len(paths), n)]),
                    "message": pa.array(messages[rng.integers(0, len(messages), n)]),
                    "status": pa.array(rng.choice([200.0, 404.0, 500.0], n)),
                    "bytes": pa.array(rng.integers(100, 50_000, n).astype(np.float64)),
                    "latency_ms": pa.array(rng.random(n) * 500),
                }
            ),
            base + timedelta(minutes=minute),
        )
    port.sync_all_streams()
    assert stream.parquet_files() == []

    jopts = JaxOptions()
    jopts.local_staging_path = tmp_path / "jax_staging"
    jax_p = JaxParseable(jopts, JaxStorageOptions(backend="local-store", root=tmp_path / "data"))
    try:
        assert jax_p.metastore.get_stream_json(STREAM).stats.events == 3 * n
        assert jax_p.metastore.get_schema(STREAM).names == sorted(
            ["p_timestamp", "host", "path", "message", "status", "bytes", "latency_ms"]
        )
        refs = {
            sql: [JaxSession(jax_p, engine=e).query(sql).table for e in ("tpu", "cpu")]
            for sql in QUERIES
        }
    finally:
        jax_p.shutdown()
    check_port_answers(port, refs)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing the whole port (every module, the server, ingest, event,
    staging, native-lane, block-tier and cluster modules named too) loads
    no JAX."""
    code = (
        "import pkgutil, sys, parseable_tpu_torch\n"
        "for m in pkgutil.walk_packages(parseable_tpu_torch.__path__, 'parseable_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import parseable_tpu_torch.query.session, parseable_tpu_torch.query.executor_cuda\n"
        "import parseable_tpu_torch.server.app, parseable_tpu_torch.server.ingest_utils\n"
        "import parseable_tpu_torch.event, parseable_tpu_torch.event.format\n"
        "import parseable_tpu_torch.event.json_format, parseable_tpu_torch.staging.writer\n"
        "import parseable_tpu_torch.staging.reader, parseable_tpu_torch.rbac\n"
        "import parseable_tpu_torch.ops.hotset, parseable_tpu_torch.ops.enccache\n"
        "import parseable_tpu_torch.ops.link, parseable_tpu_torch.ops.prefetch\n"
        "import parseable_tpu_torch.storage.enrichment, parseable_tpu_torch.query.stubs\n"
        "import parseable_tpu_torch.native\n"
        "import parseable_tpu_torch.query.fanout, parseable_tpu_torch.server.cluster\n"
        "import parseable_tpu_torch.server.flight\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'parseable_tpu' or n.startswith('parseable_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def test_gpu_engine_without_a_card_raises(tmp_path, monkeypatch):
    """A "gpu" query asks for the card; with none there it raises instead of
    answering on the CPU (the JAX session's probe-and-fall-back is not
    ported)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = port_at(tmp_path / "data", tmp_path / "staging")
    stream = port.create_stream_if_not_exists(STREAM)
    stream.write_parquet(
        pa.table({"p_timestamp": pa.array([datetime(2024, 5, 1)], pa.timestamp("ms")),
                  "host": ["a"]}),
        datetime(2024, 5, 1, tzinfo=UTC),
    )
    port.sync_all_streams()
    sql = f"SELECT host, count(*) AS c FROM {STREAM} GROUP BY host"
    assert QuerySession(port).engine == "gpu"
    with pytest.raises(DeviceUnavailable):
        QuerySession(port).query(sql)
    assert QuerySession(port, engine="cpu").query(sql).table.to_pylist() == [{"host": "a", "c": 1}]
