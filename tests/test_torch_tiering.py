"""The port's block tiers against the JAX package's, on the CPU.

Module by module, the same inputs (made from a seed with numpy) go through
the JAX package's and the port's
- encoded-block cache (`ops/enccache.py`): entries each package writes are
  read by the other, byte for byte the same file format;
- device hot set (`ops/hotset.py`): one random operation sequence, step by
  step, under both policies;
- link profile (`ops/link.py`) and query-aware prefetcher
  (`ops/prefetch.py`);
then the slice as a whole: the port's "gpu" engine with `device="cpu"` over
a lake it wrote, cold (hot set and encoded-block cache empty), disk-warm
(hot set cleared, the cache serves) and device-warm (the hot set serves),
each run against the JAX CPU engine and the port's CPU engine.

Tolerances: counts, codes, keys and bytes exact; floats as in
tests/test_torch_executor.py (rel 2e-4, abs 1e-6; min/max exact against
the JAX "tpu" engine, rel 2e-4 against the f64 CPU engines).
"""

from __future__ import annotations

import os
import threading
import time
from datetime import datetime, timedelta

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from parseable_tpu.ops import device as JD
from parseable_tpu.ops import enccache as JE
from parseable_tpu.ops import hotset as JH
from parseable_tpu.ops import link as JL
from parseable_tpu.ops import prefetch as JP
from parseable_tpu_torch.catalog import create_from_parquet_file
from parseable_tpu_torch.config import Options, StorageOptions
from parseable_tpu_torch.core import Parseable
from parseable_tpu_torch.event.format import LogSource
from parseable_tpu_torch.ops import device as PD
from parseable_tpu_torch.ops import enccache as PE
from parseable_tpu_torch.ops import hotset as PH
from parseable_tpu_torch.ops import link as PL
from parseable_tpu_torch.ops import prefetch as PP
from parseable_tpu_torch.query import executor_cuda as X
from parseable_tpu_torch.query import provider as PV
from parseable_tpu_torch.query import stubs as ST
from parseable_tpu_torch.query.executor import QueryExecutor as PortCpuExecutor
from parseable_tpu_torch.query.planner import plan as port_plan
from parseable_tpu_torch.query.session import QuerySession
from parseable_tpu_torch.query.sql import parse_sql as port_parse
from tests.test_torch_executor import CASES, assert_rows, jax_cpu, make_table

STREAM = "t"
HOST_CARDS = (2, 5, 40)


# ------------------------------------------------------------- enccache


def enc_table(seed: int = 3, n: int = 5000) -> pa.Table:
    """Every encodable kind: a timestamp, strings with nulls, a float and a
    bool column, a small and a large dictionary."""
    rng = np.random.default_rng(seed)
    base = datetime(2024, 5, 1, 10)
    ms = rng.integers(0, 3_600_000, n)
    return pa.table(
        {
            "p_timestamp": pa.array([base + timedelta(milliseconds=int(v)) for v in ms],
                                    pa.timestamp("ms")),
            "host": pa.array([f"h{int(x)}" for x in rng.integers(0, 40, n)]),
            "path": pa.array([f"/p{int(x)}" for x in rng.integers(0, 300, n)]),
            "status": pa.array(rng.choice([200.0, 404.0, 500.0], n)),
            "lat": pa.array([None if x < 0.1 else float(x) for x in rng.random(n)]),
            "ok": pa.array(rng.random(n) < 0.5),
            "msg": pa.array([f"m{int(x)}" if x % 5 else None for x in rng.integers(0, 30, n)]),
        }
    )


ALL = {"p_timestamp", "host", "path", "status", "lat", "ok", "msg"}


def norm(enc) -> dict:
    """An EncodedBatch as plain values: every column's kind, dtype, values
    and validity up to block_rows, dictionary, flags and time range."""
    cols = {
        name: (
            c.kind, str(c.values.dtype), c.values[: enc.block_rows].tobytes(),
            np.asarray(c.valid[: enc.block_rows], bool).tobytes(), c.dictionary,
            c.all_valid, c.vmin, c.vmax,
        )
        for name, c in enc.columns.items()
    }
    return {"num_rows": enc.num_rows, "block_rows": enc.block_rows,
            "time_origin_ms": enc.time_origin_ms, "columns": cols}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_enccache_entries_read_across_packages(tmp_path, writer):
    """An entry one package writes (both its variants of `status`) reads
    back in the other the same: arrays, dtypes, dictionaries, vmin/vmax,
    time origin."""
    t = enc_table()
    J, P = (JE, JD), (PE, PD)
    (wc, wd), (rc, _) = (J, P) if writer == "jax" else (P, J)
    w = wc.EncodedBlockCache(tmp_path)
    assert w.put(b"src", wd.encode_table(t, ALL))
    assert w.put(b"src", wd.encode_table(t, {"status"}, dict_columns={"status"}))
    r = rc.EncodedBlockCache(tmp_path)
    for dict_cols in (set(), {"status", "host"}):
        want = wd.encode_table(t, ALL, dict_columns=dict_cols)
        got = r.get(b"src", ALL, dict_cols)
        assert got is not None
        assert norm(got) == norm(want)


def test_enccache_files_are_byte_identical(tmp_path):
    t = enc_table(seed=9)
    JE.EncodedBlockCache(tmp_path / "j").put(b"a|1|2", JD.encode_table(t, ALL, dict_columns={"ok"}))
    PE.EncodedBlockCache(tmp_path / "p").put(b"a|1|2", PD.encode_table(t, ALL, dict_columns={"ok"}))
    (fj,), (fp,) = list((tmp_path / "j").glob("*.enc")), list((tmp_path / "p").glob("*.enc"))
    assert fj.name == fp.name
    assert fj.read_bytes() == fp.read_bytes()


def test_enccache_variant_merge_and_selection(tmp_path):
    """A numeric column stores both its f32 and forced-dict variants; each
    query shape picks the right one, and a forced dict never serves a
    non-group-by read."""
    t = enc_table()
    cache = PE.EncodedBlockCache(tmp_path)
    cache.put(b"s", PD.encode_table(t, {"status"}))
    assert cache.get(b"s", {"status"}, {"status"}) is None
    cache.put(b"s", PD.encode_table(t, {"status"}, dict_columns={"status"}))
    assert cache.get(b"s", {"status"}, {"status"}).columns["status"].kind == "dict"
    num = cache.get(b"s", {"status"}, set()).columns["status"]
    assert num.kind == "num" and num.values.dtype == np.float32
    # a string column's dict variant serves both shapes
    cache.put(b"s", PD.encode_table(t, {"host"}))
    assert cache.get(b"s", {"host"}, set()).columns["host"].kind == "dict"
    assert cache.get(b"s", {"host", "lat"}, set()) is None  # lat never written


CAN_SERVE = [
    ({"status"}, set()), ({"status"}, {"status"}), ({"host", "status"}, {"host"}),
    ({"lat", "ok"}, set()), ({"ok"}, {"ok"}), ({"msg", "p_timestamp"}, {"msg"}),
    (None, set()), ({"nope"}, set()), (set(), set()),
]


@pytest.mark.parametrize("needed,dict_cols", CAN_SERVE)
def test_enccache_can_serve_matches_jax(tmp_path, needed, dict_cols):
    t = enc_table(seed=4)
    JE.EncodedBlockCache(tmp_path).put(b"s", JD.encode_table(t, ALL - {"ok"}))
    JE.EncodedBlockCache(tmp_path).put(b"s", JD.encode_table(t, {"status"}, dict_columns={"status"}))
    want = JE.EncodedBlockCache(tmp_path).can_serve(b"s", needed, dict_cols)
    assert PE.EncodedBlockCache(tmp_path).can_serve(b"s", needed, dict_cols) == want
    got = PE.EncodedBlockCache(tmp_path).get(b"s", needed, dict_cols)
    assert (got is not None) == want


def test_enccache_evicts_oldest_over_budget(tmp_path):
    t = enc_table()
    cache = PE.EncodedBlockCache(tmp_path)
    for age, sid in ((200, b"a"), (100, b"b")):
        cache.put(sid, PD.encode_table(t, {"host"}))
        stamp = time.time() - age
        os.utime(tmp_path / PE._fname(sid), (stamp, stamp))
    cache.budget = 2 * (tmp_path / PE._fname(b"a")).stat().st_size
    cache.put(b"c", PD.encode_table(t, {"host"}))
    assert len(list(tmp_path.glob("*.enc"))) == 2
    assert cache.get(b"a", {"host"}, set()) is None  # the oldest went
    assert cache.get(b"c", {"host"}, set()) is not None


def test_enccache_source_id_isolation(tmp_path):
    cache = PE.EncodedBlockCache(tmp_path)
    cache.put(b"path|100|5000", PD.encode_table(enc_table(), {"host"}))
    # same path, another size (a rewritten object): another entry
    assert cache.get(b"path|200|5000", {"host"}, set()) is None
    assert not cache.can_serve(b"path|100|4999", {"host"}, set())
    assert cache.can_serve(b"path|100|5000", {"host"}, set())


def test_enccache_open_removes_tmp_and_stale_entries(tmp_path):
    cache = PE.EncodedBlockCache(tmp_path)
    cache.put(b"s", PD.encode_table(enc_table(), {"host"}))
    (tmp_path / "x.enc.1.2.tmp").write_bytes(b"partial")
    (tmp_path / "old.enc").write_bytes(b"PTEC2\n....")
    PE.EncodedBlockCache(tmp_path)
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".enc"]
    assert cache.get(b"s", {"host"}, set()) is not None


def test_enccache_put_async_survives_the_strip(tmp_path):
    """put_async snapshots references BEFORE the hot set strips arrays."""
    t = enc_table()
    cache = PE.EncodedBlockCache(tmp_path)
    enc = PD.encode_table(t, {"host", "lat"})
    want = norm(PD.encode_table(t, {"host", "lat"}))
    cache.put_async(b"async-src", enc)
    X._strip_host_values(enc)  # what _encoded_block does right after
    cache.wait_idle()
    try:
        assert norm(cache.get(b"async-src", {"host", "lat"}, set())) == want
    finally:
        cache.shutdown()


def test_enccache_counts_seeds_dropped_when_the_queue_is_full(tmp_path, monkeypatch):
    monkeypatch.setattr(PE, "QUEUE_DEPTH", 1)
    monkeypatch.setattr(PE, "QUEUE_TIMEOUT_S", 0.0)
    cache = PE.EncodedBlockCache(tmp_path)
    enc = PD.encode_table(enc_table(), {"host"})
    with cache._write_lock:  # the writer takes the first seed and waits here
        cache.put_async(b"s0", enc)
        deadline = time.monotonic() + 10
        while cache._queue.qsize() and time.monotonic() < deadline:
            time.sleep(0.005)
        for i in range(1, 5):  # one fills the queue, three are shed
            cache.put_async(f"s{i}".encode(), enc)
        assert cache.dropped == 3
    cache.wait_idle()
    cache.shutdown()
    landed = [cache.get(f"s{i}".encode(), {"host"}, set()) is not None for i in range(5)]
    assert landed == [True, True, False, False, False]


def test_enccache_read_survives_a_merge_put_between_header_and_payload(tmp_path, monkeypatch):
    """A merge-put of another variant that replaces the file after a read
    took its header: the read's payload still comes from the file the
    header came from, and equals the first encoding."""
    t = enc_table()
    cache = PE.EncodedBlockCache(tmp_path)
    cache.put(b"s", PD.encode_table(t, {"host"}))
    want = norm(PD.encode_table(t, {"host"}))
    size = (tmp_path / PE._fname(b"s")).stat().st_size
    real_pick = PE.EncodedBlockCache._pick
    merged = []

    def pick_then_merge(variants, want_dict):
        if not merged:  # between the header read and the payload read
            merged.append(cache.put(b"s", PD.encode_table(t, {"host", "status", "lat"})))
        return real_pick(variants, want_dict)

    monkeypatch.setattr(PE.EncodedBlockCache, "_pick", staticmethod(pick_then_merge))
    got = cache.get(b"s", {"host"}, set())
    assert merged == [True] and (tmp_path / PE._fname(b"s")).stat().st_size > size
    assert got is not None and norm(got) == want
    # the merged entry serves both the old and the new variants
    monkeypatch.undo()
    assert norm(cache.get(b"s", {"host"}, set())) == want
    assert norm(cache.get(b"s", {"status", "lat"}, set())) == norm(
        PD.encode_table(t, {"status", "lat"})
    )


# --------------------------------------------------------------- hot set


def _hot_cost(nbytes: int) -> float:
    return 0.002 + nbytes / 5e8


OPS = st.lists(
    st.one_of(
        st.tuples(st.just("put"), st.integers(0, 7), st.integers(1, 70)),
        st.tuples(st.just("get"), st.integers(0, 7), st.booleans()),
        st.tuples(st.just("touch"), st.integers(0, 7)),
        st.tuples(st.just("contains"), st.integers(0, 7)),
        st.tuples(st.just("clear")),
    ),
    max_size=60,
)


def _hot_state(hs) -> tuple:
    return (
        [(k, s.probation, s.freq, s.pri, s.seq, s.entry.nbytes) for k, s in hs._entries.items()],
        list(hs._ghost.items()),
        hs.stats_snapshot(),
    )


@pytest.mark.parametrize("policy", ["cost", "lru"])
@settings(max_examples=60, deadline=None, database=None)
@given(ops=OPS)
def test_hotset_matches_jax_step_by_step(policy, ops):
    """Resident keys in eviction order, segments, frequencies, scores,
    ghosts and the stats snapshot agree after every operation."""
    j = JH.DeviceHotSet(budget_bytes=100, policy=policy, ship_cost=_hot_cost)
    p = PH.DeviceHotSet(budget_bytes=100, policy=policy, ship_cost=_hot_cost)
    for op in ops:
        key = (f"k{op[1]}".encode(),) if len(op) > 1 else None
        if op[0] == "put":
            j.put(key, JH.HotEntry(dev={}, meta=None, nbytes=op[2]))
            p.put(key, PH.HotEntry(dev={}, meta=None, nbytes=op[2]))
        elif op[0] == "get":
            assert (j.get(key, touch=op[2]) is None) == (p.get(key, touch=op[2]) is None)
        elif op[0] == "touch":
            j.touch(key)
            p.touch(key)
        elif op[0] == "contains":
            assert j.contains(key) == p.contains(key)
        else:
            j.clear()
            p.clear()
        assert _hot_state(p) == _hot_state(j), op
        assert p.resident_bytes == j.resident_bytes and len(p) == len(j)


def test_hotset_rejects_and_counts_oversize_entries():
    hs = PH.DeviceHotSet(budget_bytes=100, ship_cost=_hot_cost)
    hs.put(("a",), PH.HotEntry(dev={}, meta=None, nbytes=60))
    hs.put(("big",), PH.HotEntry(dev={}, meta=None, nbytes=1000))
    assert not hs.contains(("big",)) and hs.contains(("a",))
    snap = hs.stats_snapshot()
    assert snap["rejected_oversize"] == 1 and snap["evictions"] == 0
    assert snap["resident_bytes"] == 60


def test_get_hotset_reroots_on_a_budget_change(monkeypatch):
    monkeypatch.setenv("P_TPU_HOT_BYTES", "1000")
    a = PH.get_hotset()
    a.put(("x",), PH.HotEntry(dev={}, meta=None, nbytes=10))
    assert PH.get_hotset() is a and a.budget == 1000 and a.policy == "cost"
    monkeypatch.setenv("P_TPU_HOT_BYTES", "2000")
    b = PH.get_hotset()
    assert b is not a and b.budget == 2000 and len(b) == 0


def test_hotset_refuses_an_unknown_policy():
    with pytest.raises(ValueError):
        PH.DeviceHotSet(budget_bytes=100, policy="lfu")


# ------------------------------------------------------------------ link

# host -> device samples: bandwidth (>= 256 KiB), latency (smaller) and a
# zero time, which is ignored
LINK_SAMPLES = [
    (1 << 20, 0.0004), (4096, 0.00002), (640, 0.00003), (13 << 20, 0.0006),
    (8 << 20, 0.0005), (1 << 22, 0.0), (3 << 20, 0.0001), (100, 0.1),
]


def _feed(prof, samples) -> None:
    for n, secs in samples:
        prof.record_h2d(n, secs)


def test_link_snapshot_matches_jax():
    j, p = JL.LinkProfile(), PL.LinkProfile()
    _feed(j, LINK_SAMPLES)
    _feed(p, LINK_SAMPLES)
    assert p.snapshot() == j.snapshot()
    for n in (0, 4096, 1 << 20, 1 << 30):
        assert p.ship_cost(n) == j.ship_cost(n)
        assert p.ship_cost_per_byte(n) == j.ship_cost_per_byte(n)


def test_link_profiles_read_each_others_files(tmp_path):
    j = JL.LinkProfile(tmp_path / "j.json")
    _feed(j, LINK_SAMPLES)
    j.record_d2h(8 << 20, 0.0005)
    j.flush()
    assert PL.LinkProfile(tmp_path / "j.json").snapshot() == j.snapshot()
    p = PL.LinkProfile(tmp_path / "p.json")
    _feed(p, LINK_SAMPLES[:5])
    p.flush()
    assert JL.LinkProfile(tmp_path / "p.json").snapshot() == p.snapshot()
    # the port saving into the JAX package's file keeps the JAX package's
    # d2h measurement and its own h2d samples
    shared = PL.LinkProfile(tmp_path / "j.json")
    _feed(shared, LINK_SAMPLES[:2])
    shared.flush()
    back = JL.LinkProfile(tmp_path / "j.json").snapshot()
    assert back == shared.snapshot()
    assert {k: v for k, v in back.items() if not k.startswith("h2d")} == {
        k: v for k, v in j.snapshot().items() if not k.startswith("h2d")
    }


def test_link_flush_bypasses_the_throttle(tmp_path):
    """A short process persists what it learned inside the 5 s window."""
    import json

    path = tmp_path / "link_profile.json"
    prof = PL.LinkProfile(path)
    prof.record_h2d(1 << 20, 1.0)  # the first save stamps the throttle
    prof.record_h2d(1 << 20, 1.0)
    prof.flush()
    stored = json.loads(path.read_text())
    assert stored["h2d_bw"] == prof.snapshot()["h2d_bw"] < 8e9 * 0.6


def test_link_merge_on_save(tmp_path):
    """Two processes on one file: keys the other moved on disk average with
    ours instead of last-writer-wins."""
    import json

    path = tmp_path / "link_profile.json"
    a, b = PL.LinkProfile(path), PL.LinkProfile(path)
    for _ in range(30):
        a.record_h2d(1 << 22, 4.0)  # ~1 MB/s
    a.flush()
    a_bw = json.loads(path.read_text())["h2d_bw"]
    assert a_bw < 1e8
    b.record_h2d(4096, 0.001)  # a latency sample: b's h2d_bw is the default
    b.flush()
    stored = json.loads(path.read_text())
    assert stored["h2d_bw"] <= 0.5 * (a_bw + 8e9) + 1e-6
    assert stored["h2d_bw"] < 8e9 * 0.6
    assert stored["h2d_lat"] < 0.002


def test_get_link_attaches_a_path_without_dropping_samples(tmp_path, monkeypatch):
    monkeypatch.setattr(PL, "_GLOBAL", None)
    monkeypatch.setattr(PL, "_GLOBAL_PATH", None)
    prof = PL.get_link()
    prof.record_h2d(1 << 20, 0.5)
    opts = Options(local_staging_path=tmp_path)
    assert PL.get_link(opts) is prof
    prof.flush()
    assert (tmp_path / "link_profile.json").exists()
    assert PL.get_link(Options(local_staging_path=tmp_path / "other")) is not prof


def test_link_flush_does_not_bring_back_a_removed_staging_dir(tmp_path):
    import shutil

    gone = tmp_path / "staging"
    gone.mkdir()
    prof = PL.LinkProfile(gone / "link_profile.json")
    prof.record_h2d(1 << 20, 0.5)  # the first sample saves at once
    shutil.rmtree(gone)
    prof.record_h2d(1 << 20, 0.5)  # inside the throttle: left for flush
    prof.flush()
    assert not gone.exists()


# -------------------------------------------------------------- prefetch


def _drive_prefetcher(mod, depth: int, plan: list[int], outcome) -> dict:
    """Consume sources in `plan` order (indices, possibly skipping ahead)
    with `outcome(i)` deciding each fake ship: a key, None (skipped) or an
    exception. Returns the counters and each block's claim/consumed."""
    sources = [f"s{i}".encode() for i in range(8)]

    def ship(sid: bytes):
        i = int(sid[1:])
        res = outcome(i)
        if isinstance(res, Exception):
            raise res
        return res

    pf = mod.ScanPrefetcher(sources, ship, depth=depth)
    seen = []
    try:
        for i in plan:
            pf.on_block(sources[i])
            claimed = pf.claim(sources[i])
            seen.append((i, claimed, pf.consumed(("k", i))))
    finally:
        counters = pf.close()
    return {"counters": {k: counters[k] for k in
                         ("prefetch_issued", "prefetch_hits", "prefetch_wasted")},
            "seen": seen, "errors": counters.get("prefetch_errors")}


PREFETCH_CASES = {
    "in-order-depth1": (1, list(range(8)), lambda i: ("k", i)),
    "in-order-depth3": (3, list(range(8)), lambda i: ("k", i)),
    "skips": (1, list(range(8)), lambda i: None if i % 3 == 0 else ("k", i)),
    "raises": (2, list(range(8)), lambda i: RuntimeError("x") if i == 4 else ("k", i)),
}


@pytest.mark.parametrize("name", list(PREFETCH_CASES))
def test_prefetcher_matches_jax(name):
    depth, plan, outcome = PREFETCH_CASES[name]
    j = _drive_prefetcher(JP, depth, plan, outcome)
    p = _drive_prefetcher(PP, depth, plan, outcome)
    assert p["counters"] == j["counters"] and p["seen"] == j["seen"]
    assert p["errors"] == (1 if name == "raises" else 0)


def test_prefetcher_counts_cargo_the_consumer_passed_as_wasted():
    shipped = threading.Event()

    def ship(sid):
        if sid == b"s2":
            shipped.set()
        return ("k", sid)

    for mod in (JP, PP):
        shipped.clear()
        pf = mod.ScanPrefetcher([f"s{i}".encode() for i in range(6)], ship, depth=2)
        pf.on_block(b"s0")  # schedules s1, s2
        assert pf.claim(b"s2") and shipped.is_set()
        pf.on_block(b"s4")  # s1 and s2 shipped, never consumed; schedules s5
        assert pf.claim(b"s5")  # shipped, and still unconsumed at close
        out = pf.close()
        assert (out["prefetch_issued"], out["prefetch_wasted"], out["prefetch_hits"]) == (3, 3, 0)


# ------------------------------------------------------ the slice, cached


def write_lake(root, tables, engine: str = "gpu") -> Parseable:
    # the result cache off: a repeated query here measures the engine's
    # block tiers, not the cached interim (tests/test_torch_result_cache.py)
    opts = Options(local_staging_path=root / "staging", query_engine=engine,
                   query_result_cache_bytes=0)
    p = Parseable(opts, StorageOptions(root=root / "data"))
    stream = p.create_stream_if_not_exists(STREAM)
    for i, t in enumerate(tables):
        stream.write_parquet(t, datetime(2024, 5, 1, 10, i))
    p.sync_all_streams()
    return p


def clear_tiers(p) -> None:
    """Cold: the hot set and the encoded-block cache emptied."""
    PH.get_hotset().clear()
    cache = PE.get_enccache(p.options)
    cache.wait_idle()
    for f in cache.root.glob("*.enc"):
        f.unlink()


def cache_states(p, sql: str) -> dict:
    """One GPU query cold, then disk-warm (hot set cleared after the
    write-behind landed), then device-warm, with the route checks of each
    state. Returns the results by state."""
    clear_tiers(p)
    cache = PE.get_enccache(p.options)
    out = {}
    for state in ("cold", "disk-warm", "device-warm"):
        if state == "disk-warm":
            cache.wait_idle()
            PH.get_hotset().clear()
        res = QuerySession(p, engine="gpu", device="cpu").query(sql)
        r, s = res.stats["device_routes"], res.stats
        blocks = s["files_total"] - s["files_pruned"]
        assert r["cpu_fallback"] == 0, (state, r)
        if state == "device-warm":
            assert (r["device_warm"], r["device_cold"]) == (blocks, 0), (state, r)
            assert r["h2d_bytes"] == r["h2d_aux_bytes"], r  # no block bytes shipped
        elif state == "disk-warm":
            # a block the prefetcher shipped from the cache is found hot
            assert r["device_warm"] == r.get("prefetch_hits", 0), (state, r)
            assert r["device_warm"] + r["device_cold"] == blocks, (state, r)
            assert (r["h2d_bytes"] > r["h2d_aux_bytes"]) == (blocks > 0), (state, r)
        else:
            assert (r["device_warm"], r["device_cold"]) == (0, blocks), (state, r)
        # a cached block reads no Parquet
        assert (s["bytes_scanned"] > 0) == (state == "cold" and blocks > 0), (state, s)
        assert s["stages"]["hotset"]["entries"] >= blocks
        out[state] = res
    return out


@pytest.fixture(scope="module")
def exec_lake(tmp_path_factory):
    tables = [make_table(40 + i, 3000, card) for i, card in enumerate(HOST_CARDS)]
    p = write_lake(tmp_path_factory.mktemp("tiers"), tables)
    yield p, tables
    p.shutdown()
    PH.get_hotset().clear()


@pytest.mark.parametrize("name", list(CASES))
def test_cache_states_match_both_cpu_engines(name, exec_lake):
    p, tables = exec_lake
    sql = CASES[name]
    ordered = "ORDER BY" in sql
    ref = jax_cpu(sql, tables)
    port = QuerySession(p, engine="cpu").query(sql).table.to_pylist()
    assert_rows(ref, port, sql, exact_minmax=False, ordered=ordered)
    for state, res in cache_states(p, sql).items():
        assert_rows(ref, res.table.to_pylist(), f"{state}: {sql}", False, ordered=ordered)
        assert_rows(port, res.table.to_pylist(), f"{state}: {sql}", False, ordered=ordered)


def test_upload_seed_serves_every_manifest_file(exec_lake):
    """After sync_all_streams the seed has written every uploaded file's
    encoding: the cache can serve each manifest file's every column."""
    p, tables = exec_lake
    scan = PV.StreamScan(p, port_plan(port_parse(f"SELECT count(*) FROM {STREAM}")))
    files = scan.manifest_files()
    assert len(files) == len(tables)
    p2 = write_lake(p.options.local_staging_path.parent / "seeded", tables)
    try:
        cache = PE.get_enccache(p2.options)
        for f in PV.StreamScan(p2, scan.plan).manifest_files():
            sid = f"{f.file_path}|{f.file_size}|{f.num_rows}".encode()
            assert cache.can_serve(sid, set(tables[0].column_names), set()), f.file_path
            assert not list(p2.streams.get(STREAM).data_path.glob("*.enrich"))
    finally:
        p2.shutdown()
        PE.get_enccache(p.options)


def test_no_seed_for_the_cpu_engine(tmp_path):
    p = write_lake(tmp_path, [make_table(1, 500, 3)], engine="cpu")
    try:
        assert not list((tmp_path / "staging" / "encoded_cache").glob("*.enc"))
    finally:
        p.shutdown()


def test_stub_eviction_race_rereads_the_source(tmp_path, monkeypatch):
    """A block evicted between the scan's hot check and execution is read
    again from its source (`executor.source_loader`)."""
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")
    p = write_lake(tmp_path, [make_table(7, 2000, 4), make_table(8, 2000, 6)])
    try:
        sql = f"SELECT host, count(*) AS c, sum(bytes) AS b FROM {STREAM} GROUP BY host ORDER BY host"
        PH.get_hotset().clear()
        first = QuerySession(p, engine="gpu", device="cpu").query(sql)
        hs = PH.get_hotset()
        orig = hs.get
        cleared = []

        def evil_get(key, touch=True):
            entry = orig(key, touch)
            if entry is not None and not cleared:
                cleared.append(key)  # the scan saw it hot; evict before execution
                hs.clear()
            return entry

        monkeypatch.setattr(hs, "get", evil_get)
        again = QuerySession(p, engine="gpu", device="cpu").query(sql)
        assert cleared and again.table.to_pylist() == first.table.to_pylist()
        r = again.stats["device_routes"]
        assert r["cpu_fallback"] == 0 and r["device_cold"] >= 1, r
        assert again.stats["bytes_scanned"] > 0  # the evicted stub's source re-read
    finally:
        p.shutdown()


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT host AS g0, count(distinct p_timestamp) AS d0 FROM t GROUP BY g0",
        "SELECT host AS g0, approx_distinct(p_timestamp) AS d0 FROM t GROUP BY g0",
    ],
    ids=["count-distinct", "approx-distinct"],
)
def test_distinct_over_the_timestamp_column_takes_the_cpu_engine_when_resident(sql, monkeypatch):
    """A stub block has no columns, so the guard reads the encoding: a
    resident block whose distinct column holds timestamps folds on the host
    (read again from its source), never as dictionary codes read as ms."""
    monkeypatch.setenv("P_TPU_ENC_CACHE", "0")  # a made-up source id
    table = make_table(11, 3000, 5)
    lp = port_plan(port_parse(sql))
    dict_cols = ST.dict_group_columns(lp.select) | {"p_timestamp"}
    enc = PD.encode_table(table, lp.needed_columns, dict_columns=dict_cols)
    dev, nbytes, _ = X._ship_block(enc, torch.device("cpu"))
    X._strip_host_values(enc)
    hs = PH.get_hotset()
    hs.clear()
    hs.put(ST.hot_key(b"src", lp.needed_columns, dict_cols), PH.HotEntry(dev, enc, nbytes))
    ex = X.GpuQueryExecutor(lp, device="cpu")
    ex.source_loader = lambda sid: table.replace_schema_metadata({ST.SOURCE_ID_META: sid})
    got = ex.execute(iter([ST.make_stub(b"src", table.num_rows)])).to_pylist()
    r = ex.route_stats
    assert (r["device_warm"], r["device_cold"], r["cpu_fallback"]) == (0, 0, 1), r
    want = PortCpuExecutor(port_plan(port_parse(sql))).execute(iter([table])).to_pylist()
    assert sorted(got, key=str) == sorted(want, key=str)
    hs.clear()


def test_an_executor_without_options_leaves_the_cache_where_it_is(tmp_path, monkeypatch):
    """Only a caller's own options root the process-wide encoded-block
    cache: an executor built without them writes behind into the cache
    that is there, and makes none under the working directory."""
    monkeypatch.chdir(tmp_path)
    cache = PE.EncodedBlockCache(tmp_path / "cache")
    monkeypatch.setattr(PE, "_GLOBAL", cache)
    monkeypatch.setattr(PE, "_GLOBAL_ROOT", cache.root)
    lp = port_plan(port_parse("SELECT host AS g0, count(*) AS c0 FROM t GROUP BY g0"))
    sid = b"src|1|500"
    table = make_table(12, 500, 3).replace_schema_metadata({ST.SOURCE_ID_META: sid})
    PH.get_hotset().clear()
    ex = X.GpuQueryExecutor(lp, device="cpu")
    try:
        ex.execute(iter([table]))
        assert ex.route_stats["device_cold"] == 1, ex.route_stats
        cache.wait_idle()
        assert PE.get_enccache() is cache
        assert cache.can_serve(sid, lp.needed_columns, ST.dict_group_columns(lp.select))
        assert not (tmp_path / "staging").exists()
    finally:
        cache.shutdown()
        PH.get_hotset().clear()


def test_the_scan_layer_does_not_load_the_gpu_executor():
    """The stubs live in a module of their own (query/stubs.py): the scan,
    and so a CPU-engine query, loads no GPU executor."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, parseable_tpu_torch.query.provider\n"
        "assert 'parseable_tpu_torch.query.executor_cuda' not in sys.modules\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stdout + out.stderr


def test_blocks_pass_a_stub_through_as_its_own_block():
    ex = X.GpuQueryExecutor(port_plan(port_parse("SELECT count(*) FROM t")), device="cpu")
    small = pa.table({"a": [1, 2]})
    stub = ST.make_stub(b"src", 5)
    out = list(ex._blocks(iter([small, stub, small])))
    assert [ST.is_stub(t) for t in out] == [True, False]
    assert out[1].num_rows == 4 and ST.is_stub(ST.make_stub(b"x", 0))


def test_a_stub_past_the_device_budget_folds_on_the_host(tmp_path, monkeypatch):
    """Past the group budget a query with set state (count(distinct)) folds
    the rest of its blocks on the host; a resident one is read from its
    source first (the CPU-fallback handler materializes it). A query
    without such state folds the same resident stubs block-local on the
    device instead, reading no Parquet."""
    tables = [make_table(20 + i, 2000, card) for i, card in enumerate((2, 6, 30))]
    p = write_lake(tmp_path, tables)
    try:
        sql = (f"SELECT host AS g0, count(*) AS c0, count(distinct path) AS c1 FROM {STREAM} "
               f"GROUP BY g0")
        local_sql = f"SELECT host AS g0, count(*) AS c0, avg(lat) AS a0 FROM {STREAM} GROUP BY g0"
        PH.get_hotset().clear()
        for q in (sql, local_sql):
            QuerySession(p, engine="gpu", device="cpu").query(q)  # all resident
        monkeypatch.setattr(X, "DENSE_G_MAX", 4)
        res = QuerySession(p, engine="gpu", device="cpu").query(sql)
        r = res.stats["device_routes"]
        assert r["cpu_fallback"] >= 1 and r["device_warm"] >= 1 and r["device_local"] == 0, r
        assert res.stats["bytes_scanned"] > 0  # the stubs' sources were read
        assert_rows(jax_cpu(sql.replace(STREAM, "t"), tables), res.table.to_pylist(), sql, False)
        res = QuerySession(p, engine="gpu", device="cpu").query(local_sql)
        r = res.stats["device_routes"]
        assert (r["device_warm"], r["device_local"], r["cpu_fallback"]) == (3, 2, 0), r
        assert res.stats["bytes_scanned"] == 0
        want = jax_cpu(local_sql.replace(STREAM, "t"), tables)
        assert_rows(want, res.table.to_pylist(), local_sql, False)
    finally:
        p.shutdown()


def test_a_rewritten_file_is_a_new_source(tmp_path):
    """A file rewritten in place (same path, other size and rows) is not
    served from the hot set or the cache under its old encoding."""
    a, b = make_table(30, 2000, 3), make_table(31, 1500, 7)
    p = write_lake(tmp_path, [a])
    try:
        sql = f"SELECT host AS g0, count(*) AS c0 FROM {STREAM} GROUP BY g0"
        PH.get_hotset().clear()
        for _ in range(2):  # the second run is device-warm
            first = QuerySession(p, engine="gpu", device="cpu").query(sql)
        assert first.stats["device_routes"]["device_warm"] == 1
        scan = PV.StreamScan(p, port_plan(port_parse(sql)))
        (f,) = scan.manifest_files()
        new = tmp_path / "rewrite.parquet"
        pq.write_table(b, new)
        p.storage.upload_file(f.file_path, new)
        prefix = f.file_path.split("/hour=")[0]
        manifest = p.metastore.get_manifest(prefix)
        manifest.apply_change(create_from_parquet_file(f.file_path, new))
        p.metastore.put_manifest(prefix, manifest)
        res = QuerySession(p, engine="gpu", device="cpu").query(sql)
        r = res.stats["device_routes"]
        assert (r["device_warm"], r["device_cold"]) == (0, 1), r
        want = PortCpuExecutor(port_plan(port_parse(sql))).execute(iter([b])).to_pylist()
        assert_rows(want, res.table.to_pylist(), sql, False)
    finally:
        p.shutdown()


def test_hot_set_pressure_evicts_and_the_prefetcher_ships(tmp_path, monkeypatch):
    """A hot-set budget below one query's blocks: evictions, and the
    prefetcher's ships consumed; answers unchanged."""
    tables = [make_table(50 + i, 4000, 6) for i in range(6)]
    p = write_lake(tmp_path, tables)
    try:
        sql = (f"SELECT date_bin(interval '1 minute', p_timestamp) AS g0, status AS g1, "
               f"count(*) AS c0, sum(bytes) AS a0, avg(lat) AS a1 FROM {STREAM} GROUP BY g0, g1")
        cache_states(p, sql)  # leaves every variant in the encoded-block cache
        block = max(e.entry.nbytes for e in PH.get_hotset()._entries.values())
        monkeypatch.setenv("P_TPU_HOT_BYTES", str(int(2.5 * block)))
        ref = jax_cpu(sql.replace(STREAM, "t"), tables)
        stages = []
        for _ in range(2):
            res = QuerySession(p, engine="gpu", device="cpu").query(sql)
            assert res.stats["device_routes"]["cpu_fallback"] == 0
            assert_rows(ref, res.table.to_pylist(), sql, False)
            stages.append(res.stats["stages"]["hotset"])
        assert stages[-1]["evictions"] > 0, stages
        assert sum(s["prefetch_hits"] for s in stages) > 0, stages
        assert all(s["prefetch_errors"] == 0 for s in stages), stages
        assert stages[-1]["resident_bytes"] <= stages[-1]["budget_bytes"]
    finally:
        p.shutdown()


def test_orphaned_enrich_links_are_removed_on_restart(tmp_path):
    p = write_lake(tmp_path, [make_table(3, 200, 2)])
    p.shutdown()
    data = p.streams.get(STREAM).data_path
    (data / "x.data.parquet.enrich").write_bytes(b"left by a crash")
    p2 = Parseable(p.options, p.storage_options)
    try:
        p2.load_streams_from_storage()
        assert not list(data.glob("*.enrich"))
    finally:
        p2.shutdown()


def test_server_stop_leaves_no_cache_or_enrichment_thread(tmp_path):
    from parseable_tpu_torch.server.app import start_server
    from parseable_tpu_torch.server.ingest_utils import flatten_and_push_logs

    opts = Options(address="127.0.0.1:0", local_staging_path=tmp_path / "staging",
                   local_sync_interval_secs=3600, upload_interval_secs=3600)
    server = start_server(opts, StorageOptions(root=tmp_path / "data"), device="cpu")
    p = server.state.p
    try:
        p.create_stream_if_not_exists("demo")
        flatten_and_push_logs(p, "demo", [{"host": f"h{i % 3}", "v": i % 4} for i in range(50)],
                              LogSource.JSON)
        p.local_sync(shutdown=True)
        p.sync_all_streams()
        # a numeric group key needs a dictionary variant the upload seed did
        # not write: a live encode, and a write-behind
        sql = "SELECT v, count(*) AS c FROM demo GROUP BY v"
        PH.get_hotset().clear()
        res = QuerySession(p, engine="gpu", device="cpu").query(sql)
        assert res.stats["device_routes"]["device_cold"] == 1
        workers = [p.enrichment._worker, PE.get_enccache(p.options)._writer]
        assert all(w is not None and w.is_alive() for w in workers), workers
    finally:
        server.stop()
    assert not [w.name for w in workers if w.is_alive()]


def test_gpu_query_without_a_card_raises_with_blocks_resident(exec_lake, monkeypatch):
    """Resident blocks are no route off the card: a "gpu" query on a
    machine without one raises, hot entries or not."""
    from parseable_tpu_torch.utils.devicecheck import DeviceUnavailable

    p, _ = exec_lake
    sql = CASES["config3"]
    QuerySession(p, engine="gpu", device="cpu").query(sql)
    assert len(PH.get_hotset()) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        QuerySession(p, engine="gpu").query(sql)


# ----------------------------------------- f64 copies, concurrent queries


def test_enccache_keeps_f64_copies_and_exact_markers(tmp_path):
    """An entry written for a WHERE that compares lat (not exact in f32)
    and status (exact) holds lat's f64 copy and a marker for status; a
    read that asks for them gets both back, and so does can_serve. An
    entry written without them misses such a read until a query's
    write-behind adds them; the upload seed writes the markers only."""
    t = enc_table()
    asked = {"lat", "status", PD.f64_name("lat"), PD.f64_name("status")}
    cache = PE.EncodedBlockCache(tmp_path)
    assert cache.put(b"plain", PD.encode_table(t, {"lat", "status"}))
    assert not cache.can_serve(b"plain", asked, set())
    assert cache.get(b"plain", asked, set()) is None
    live = PD.encode_table(t, asked)
    assert live.exact_cols == {"status"} and PD.f64_name("lat") in live.columns
    for source in (b"plain", b"fresh"):
        assert cache.put(source, live)
        assert cache.can_serve(source, asked, set())
        got = cache.get(source, asked, set())
        assert got.exact_cols == {"status"} and set(got.columns) == asked - {PD.f64_name("status")}
        wide = got.columns[PD.f64_name("lat")]
        np.testing.assert_array_equal(wide.values, live.columns[PD.f64_name("lat")].values)
        assert wide.values.dtype == np.float64
    # the upload seed (every column) marks status exact and copies nothing
    seed = PD.encode_table(t, None)
    assert seed.exact_cols == {"status"} and not any(PD.f64_base(c) for c in seed.columns)
    assert cache.put(b"seeded", seed)
    assert cache.can_serve(b"seeded", {"status", PD.f64_name("status")}, set())
    assert not cache.can_serve(b"seeded", asked, set())
    # a group key reads status as codes: its f64 copy is not needed
    assert not cache.can_serve(b"fresh", asked, {"status"})
    assert cache.put(b"fresh", PD.encode_table(t, {"status"}, dict_columns={"status"}))
    assert cache.can_serve(b"fresh", asked, {"status"})
    got = cache.get(b"fresh", asked, {"status"})
    assert got.columns["status"].kind == "dict" and got.exact_cols == set()


@pytest.mark.parametrize("engine", ["cpu", "gpu"])
def test_concurrent_identical_queries_answer_in_full(tmp_path, engine):
    """12 threads send the same GROUP BY through QuerySession at once: each
    answers the JAX CPU engine's table in full (the JAX "tpu" engine
    answers most of them empty, tests/test_query_concurrency.py
    ::test_load_smoke_counters_monotonic)."""
    tables = [make_table(80 + i, 100, 5) for i in range(3)]
    p = write_lake(tmp_path, tables, engine="gpu" if engine == "gpu" else "cpu")
    sql = f"SELECT host AS g0, count(*) AS c0 FROM {STREAM} GROUP BY g0"
    want = jax_cpu(sql.replace(STREAM, "t"), tables)
    assert sum(r["c0"] for r in want) == 300
    PH.get_hotset().clear()
    start = threading.Barrier(12)
    answers: list = [None] * 12

    def one(i: int) -> None:
        sess = QuerySession(p, engine=engine, device="cpu" if engine == "gpu" else None)
        start.wait()
        answers[i] = sess.query(sql).table.to_pylist()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    p.shutdown()
    PH.get_hotset().clear()
    for got in answers:
        assert got is not None
        assert_rows(want, got, sql, exact_minmax=False)
