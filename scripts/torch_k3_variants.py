#!/usr/bin/env python3
"""Time design variants of the port's K3 kernels (`mask_ids`, K3a, and
`stack_operands`, K3b) on one NVIDIA card, in turns.

    python3 scripts/torch_k3_variants.py [--variants source,run8,run4] [--json out.json]

Each variant is `parseable_tpu_torch/csrc/fold.cu` with one design choice
changed (VARIANTS: `runR`, R rows a thread instead of 16), built with
nvcc into
`build/k3_variants/<name>/` and called through the port's wrappers
(`ops/fold_cuda.py`, its library swapped in). Inputs are
the K3 calls of four queries of `chip_smoke.py` (minmax, select_filter,
groupby, stats_status) on one minute of its lake (2^20 rows), recorded
while the "gpu" engine answers them on the card. Every variant's outputs
are checked bit for bit against the plain versions, then each call is timed
device-only (`chip_smoke.DeviceTimer`: 20 calls between CUDA events,
L2-cold over input copies that exceed L2) in turns, first to last and back.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "parseable_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k3_variants"
QUERIES = ("minmax", "select_filter", "groupby", "stats_status")


# variant -> (line of fold.cu, its replacement, rows a thread)
VARIANTS = {
    "source": (None, None, 16),
    "run8": ("constexpr int kRun = 16;", "constexpr int kRun = 8;", 8),
    "run4": ("constexpr int kRun = 16;", "constexpr int kRun = 4;", 4),
}


def build(name: str) -> ctypes.CDLL:
    """fold.cu as variant `name`, compiled and loaded."""
    from parseable_tpu_torch.ops import cuda_lib
    from parseable_tpu_torch.ops import fold_cuda as F

    text = (CSRC / "fold.cu").read_text()
    line, new, _ = VARIANTS[name]
    if line is not None:
        if line not in text:
            raise SystemExit(f"fold.cu holds no `{line}` line to vary")
        text = text.replace(line, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "fold.cu").write_text(text)
    shutil.copy(CSRC / "common.cuh", d / "common.cuh")
    lib = d / "libfold.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(d / "fold.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name}:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    F._bind(so)
    return so


def record_calls(torch, np, pa) -> "object":
    """The K3 calls of QUERIES over one minute of chip_smoke's lake."""
    import chip_smoke
    from parseable_tpu_torch.ops import fold_cuda as F
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.executor_cuda import SOURCE_ID_META, GpuQueryExecutor
    from parseable_tpu_torch.query.planner import plan
    from parseable_tpu_torch.query.sql import parse_sql

    table = chip_smoke.make_minute(pa, np, np.random.default_rng(42), 2, chip_smoke.N_BLOCK)
    block = table.replace_schema_metadata({SOURCE_ID_META: b"k3-variants"})
    texts = {**chip_smoke.QUERIES, **chip_smoke.STATS_QUERIES,
             **{k: q for k, (q, _) in chip_smoke.SELECT_QUERIES.items()}}
    os.environ["P_TPU_ENC_CACHE"] = "0"
    with chip_smoke.K3Recorder(F) as rec:
        for q in QUERIES:
            rec.query = q
            get_hotset().clear()
            GpuQueryExecutor(plan(parse_sql(texts[q].format(stream="t"))), device="cuda").execute(
                iter([block]))
    torch.cuda.synchronize()
    get_hotset().clear()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="source,run8,run4",
                    help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--json", help="write the results here too")
    args = ap.parse_args()

    import numpy as np
    import pyarrow as pa
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from parseable_tpu_torch.ops import fold_cuda as F

    runs = args.variants.split(",")
    libs = {r: build(r) for r in runs}
    F.LIBRARY.load()
    rec = record_calls(torch, np, pa)
    timer = chip_smoke.DeviceTimer(torch)

    def use(name: str) -> None:
        F.LIBRARY._lib, F.RUN = libs[name], VARIANTS[name][2]

    results: dict = {}
    for kind in chip_smoke.K3_KERNELS:
        for q in QUERIES:
            data = rec.inputs[kind].get(q)
            if data is None:
                continue
            nbytes, ops = chip_smoke.k3_bytes(F, kind, data)
            copies = chip_smoke.n_copies(nbytes)
            sets = [data] + [chip_smoke.clone_args(data) for _ in range(copies - 1)]
            for r in runs:
                use(r)
                chip_smoke.k3_check(torch, F, kind, data, f"{kind} {q} {r}")
            order = runs + runs[::-1]
            times: dict[str, list] = {r: [] for r in runs}
            for r in order:
                use(r)
                if kind == "mask_ids":
                    fn = lambda k: F.mask_ids(sets[k][0], sets[k][1], sets[k][2],  # noqa: E731
                                              with_ids=sets[k][3])
                else:
                    fn = lambda k: F.stack_operands(*sets[k])  # noqa: E731
                times[r].append(round(timer.ms(fn, copies) * 1e3, 3))
            bound = chip_smoke.bound_ms(nbytes, ops)[0] * 1e3
            res = {"kernel": kind, "query": q, "bound_us": round(bound, 3),
                   "us_in_turns": times}
            results[f"{kind} {q}"] = res
            print(json.dumps(res), flush=True)
    use(runs[0])
    print(chip_smoke.nvidia_smi())
    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
