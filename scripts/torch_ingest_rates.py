#!/usr/bin/env python3
"""Ingest rates of the port's native JSON lane, on the host CPU (no card).

    python3 scripts/torch_ingest_rates.py [--bodies 16] [--clients 4] [--seed 43]

Makes `chip_smoke.py` phase 6's request bodies (16,384 access-log events
each, the same generator), then prints, one JSON line each:
- `parse`: parse-only rows/s and MB/s of every tier of the ladder
  (`chip_smoke.parse_rates`: columnar with the module's shard count and
  with one shard, NDJSON, the Python lane), one body at a time;
- `in_process`: `flatten_and_push_logs` on every body, one at a time, into
  a fresh stream (staging included);
- `http`: the port's server in this process (query engine "cpu", so no card
  is needed) answering the bodies over HTTP from `--clients` threads: rows/s,
  ack p50/p99, and the lane counters.
Everything runs in a temporary directory that is deleted at the end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bodies", type=int, default=16, help="request bodies of 16,384 events")
    ap.add_argument("--clients", type=int, default=4, help="HTTP client threads")
    ap.add_argument("--seed", type=int, default=43, help="seed of the events")
    args = ap.parse_args()

    import numpy as np

    import chip_smoke as cs
    from parseable_tpu_torch import native
    from parseable_tpu_torch.config import Options, StorageOptions
    from parseable_tpu_torch.core import Parseable
    from parseable_tpu_torch.event.format import LogSource
    from parseable_tpu_torch.server import ingest_utils as IU
    from parseable_tpu_torch.server.app import start_server

    rng = np.random.default_rng(args.seed)
    bodies = cs.request_bodies(cs.make_events(np, rng, args.bodies * cs.EVENTS_PER_REQUEST),
                               cs.EVENTS_PER_REQUEST)
    native.load()
    print(json.dumps({"bodies": len(bodies), "bytes_per_body": len(bodies[0]),
                      "bytes_per_event": len(bodies[0]) / cs.EVENTS_PER_REQUEST}))
    print(json.dumps({"parse": cs.parse_rates(bodies, len(bodies))}))

    work = Path(tempfile.mkdtemp(prefix="ingest_rates_"))
    try:
        opts = Options()
        opts.local_staging_path = work / "staging"
        p = Parseable(opts, StorageOptions(root=work / "data"))
        try:
            p.create_stream_if_not_exists("rates")
            IU.reset_lane_stats()
            t = time.perf_counter()
            rows = sum(IU.flatten_and_push_logs(p, "rates", None, LogSource.JSON, {}, raw_body=b)
                       for b in bodies)
            dt = time.perf_counter() - t
            print(json.dumps({"in_process": {"rows": rows, "s": round(dt, 4),
                                             "rows_per_s": round(rows / dt, 1),
                                             "lanes": IU.lane_stats()}}))
        finally:
            p.shutdown()

        opts = Options()
        opts.address = "127.0.0.1:0"
        opts.local_staging_path = work / "server_staging"
        opts.query_engine = "cpu"
        opts.local_sync_interval_secs = opts.upload_interval_secs = 3600
        server = start_server(opts, StorageOptions(root=work / "server_data"))
        try:
            IU.reset_lane_stats()
            acked, lat, wall = cs.send_events(server.port, bodies, args.clients)
            lat_ms = np.array(lat) * 1e3
            print(json.dumps({"http": {
                "rows": acked, "s": round(wall, 4), "rows_per_s": round(acked / wall, 1),
                "clients": args.clients, "ack_p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
                "ack_p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
                "lanes": IU.lane_stats(),
            }}))
        finally:
            server.stop()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
