#!/usr/bin/env python3
"""Time design variants of the port's statistics kernels K5, K6 and K7 on
one NVIDIA card, against each other and the earlier regimes.

    python3 scripts/torch_stats_variants.py [--variants a,b,...] [--json out.json]

Each variant is `parseable_tpu_torch/csrc/stats.cu` with one design choice
of the "compact" regime undone or changed (see VARIANTS), built with nvcc
into `build/variants/<name>/` and called through its C entry points. Every
variant's result is checked against the plain PyTorch version on every
block (K5 and K6 bit for bit, K7 within rel 2e-4 of its f64 sums), then each is timed device-only (`chip_smoke.DeviceTimer`:
20 calls between CUDA events, L2-cold over 16 input copies) in turns,
forward then backward, beside the "global" and "shared" regimes of the
unchanged source. Blocks: 2^20 rows shaped like the main path's
(`chip_smoke.py` phase 7: a minute file reaching 3 of 64 groups for
stats_minute, 8 status groups for stats_status) and uniform ones whose CTAs
each touch more groups than a compact copy holds; K7 on stats_status's
shape (Q = 2, G = 8, half of the rows in one group) and uniform ones.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "parseable_tpu_torch" / "csrc" / "stats.cu"
HEADER = ROOT / "parseable_tpu_torch" / "csrc" / "common.cuh"
COPIES = 16
HOSTS = [f"10.0.{i}.{j}" for i in range(4) for j in range(8)]  # chip_smoke.make_minute's
MODES = {"shared": 0, "global": 1, "compact": 2}

MARKS_BATCHED = '''template <int R>
__device__ __forceinline__ bool mark_groups(unsigned* bits, int* marked, int cap,
                                            const int (&g)[R]) {
  if (__shfl_sync(kFull, *(volatile int*)marked, 0) > cap) return false;
  unsigned old[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    old[k] = ~0u;
    if (g[k] < 0) continue;
    const unsigned bit = 1u << (g[k] & 31);
    if (!(bits[g[k] >> 5] & bit)) old[k] = atomicOr(bits + (g[k] >> 5), bit);
  }
  unsigned firsts = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) firsts += g[k] >= 0 && !(old[k] & (1u << (g[k] & 31)));
  firsts = __reduce_add_sync(kFull, firsts);
  if (firsts && (threadIdx.x & 31) == 0) atomicAdd(marked, (int)firsts);
  return true;
}
'''
FOLD_BATCHED = '''template <bool HLL, int R>
__device__ __forceinline__ void fold_rows(unsigned* acc, int cap, const int (&g)[R],
                                          const int (&slot)[R], const unsigned (&val)[R]) {
  unsigned held[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    held[k] = g[k] < 0 ? 0u : __ldcg(acc + (long long)g[k] * cap + slot[k]);
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (g[k] < 0) continue;
    unsigned* p = acc + (long long)g[k] * cap + slot[k];
    if (HLL) {
      if (val[k] > held[k]) atomicMax(p, val[k]);
    } else if (held[k] != kOne) {
      *p = kOne;
    }
  }
}
'''
MARKS_START = "template <int R>\n__device__ __forceinline__ bool mark_groups("
FOLD_START = "template <bool HLL, int R>\n__device__ __forceinline__ void fold_rows("
K5_BOUNDS = ("__global__ void __launch_bounds__(kCompactThreads)\n    distinct_compact_kernel",
             "__global__ void __launch_bounds__(kCompactThreads, 2)\n    distinct_compact_kernel")
K6_BOUNDS = ("__global__ void __launch_bounds__(kCompactThreads, 2)\n    pct_hist_compact_kernel",
             "__global__ void __launch_bounds__(kCompactThreads)\n    pct_hist_compact_kernel")

HLL_WORDS = "constexpr int kHllCopyWords = 2 * kCompactThreads * kDistinctRows;"
K6_PENDING = "  bool pending = true;  // this thread's rows are still to add\n"
AGG_CROWD = ("  const bool crowd = crowded(g[0] < 0 ? -1 - (int)(threadIdx.x & 31)"
             " : g[0] * kNB + slot[0]);\n")
K6_ADD = "    if (key[k] >= 0) atomicAdd(c.copy + (key[k] >> 1), 1u << ((key[k] & 1) << 4));\n"
AGG_ADD = """    const unsigned lane = 1u << (threadIdx.x & 31);
    const unsigned peers = crowd ? __match_any_sync(kFull, key[k]) : lane;
    if (key[k] >= 0 && !(peers & (lane - 1u))) {
      atomicAdd(c.copy + (key[k] >> 1), (unsigned)__popc(peers) << ((key[k] & 1) << 4));
    }
"""
# name -> (what it changes, text substitutions, function bodies replaced)
VARIANTS = {
    "compact": ("the source as it is", [], []),
    "no-direct": ("a bitmap and prefix counts even where every group's copy fits 8 histograms",
                  [("c.direct = all <= kPreZeroWords", "c.direct = false && all <= kPreZeroWords")],
                  []),
    "no-register-prefix": ("bit_prefix (two barriers) for every bitmap, not per warp up to 32 words",
                           [("constexpr int kRegPrefixW = 32;", "constexpr int kRegPrefixW = 0;")],
                           []),
    "warp-aggregation": ("K6: lanes of a crowded warp that share a slot add once (common.cuh "
                         "crowded() on the first row, dropped rows as keys of their own)",
                         [(K6_PENDING, AGG_CROWD + K6_PENDING), (K6_ADD, AGG_ADD)], []),
    "all-global": ("every CTA with a bitmap folds with global atomics at once (no marks)",
                   [("*marked = c.W || c.direct ? 0 : c.cap + 1;",
                     "*marked = c.direct ? 0 : c.cap + 1;")], []),
    "hll-copy-rows": ("K5 HLL: a copy of at most as many registers as rows a CTA holds",
                      [(HLL_WORDS, "constexpr int kHllCopyWords = kCompactThreads * kDistinctRows;")],
                      []),
    "hll-copy-any": ("K5 HLL: a copy of as many groups as shared memory holds",
                     [(HLL_WORDS, "constexpr int kHllCopyWords = 0x7fffffff;")], []),
    "marks-batched": ("a warp marks all its rows and counts once, one check a warp",
                      [], [(MARKS_START, MARKS_BATCHED)]),
    "fold-batched": ("K5's global fold reads all a thread's entries first",
                     [], [(FOLD_START, FOLD_BATCHED)]),
    "k5-two-ctas": ("K5: 4 rows a thread, two CTAs an SM (32 registers)",
                    [("constexpr int kDistinctRows = 8;", "constexpr int kDistinctRows = 4;"),
                     K5_BOUNDS], []),
    "k6-one-cta": ("K6: 8 rows a thread, one CTA an SM",
                   [("constexpr int kPctRows = 4;", "constexpr int kPctRows = 8;"), K6_BOUNDS],
                   []),
    "k7-full-occupancy": ("K7: 32 registers a thread, two CTAs an SM",
                          [("__global__ void __launch_bounds__(kCompactThreads)\n    m2_compact_kernel",
                            "__global__ void __launch_bounds__(kCompactThreads, 2)\n"
                            "    m2_compact_kernel")], []),
    "k7-one-quad": ("K7: one quad a thread, as many CTAs as the block needs",
                    [("constexpr int kM2Quads = 2;", "constexpr int kM2Quads = 1;")], []),
}


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    _, subs, bodies = VARIANTS[name]
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the source exactly once")
        text = text.replace(old, new)
    for start, body in bodies:
        i = text.index(start)
        j = text.index("\n}\n", i) + 3
        text = text[:i] + body + text[j:]
    return text


def build(name: str) -> tuple[str, Path]:
    from parseable_tpu_torch.ops import cuda_lib

    out = ROOT / "build" / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "stats.cu").write_text(variant_source(name))
    (out / "common.cuh").write_text(HEADER.read_text())
    so = out / "libstats.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(out / "stats.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name} did not build:\n{r.stderr[-4000:]}")
    return name, so


def blocks(torch, SC, seed: int) -> dict:
    """2^20-row blocks, main-path-shaped and uniform, as (kind, G, cap, tensors);
    K7's cap is its Q."""
    from parseable_tpu_torch.ops.hll_sketch import luts_for_dictionary

    rng = np.random.default_rng(seed)
    n = 1 << 20
    t = torch.from_numpy
    status = np.array([200, 200, 200, 200, 301, 404, 500, 503])[rng.integers(0, 8, n)]
    code = np.searchsorted(np.array([200, 301, 404, 500, 503]), status).astype(np.int32)
    lat = (rng.random(n) * 500).astype(np.float32)
    minute = t(3 * 8 + code)  # one minute file: 3 of 64 (minute x status) groups live
    errors = t(status >= 400)
    out = {
        "main K6 G=64": ("pct", 64, 0, (t(lat), minute, errors)),
        "main K6 G=8": ("pct", 8, 0, (t(lat), t(code), torch.ones(n, dtype=torch.bool))),
        "main presence 64x128": ("dist", 64, 128, (minute, t(rng.integers(0, 64, n).astype(np.int8)),
                                                   errors, t(rng.permutation(64).astype(np.int32)))),
        # the lake's 32 hosts, hashed as approx_distinct hashes them
        "main HLL 64x4096": ("dist", 64, 4096, (
            minute, t(rng.integers(0, 32, n).astype(np.int8)), errors,
            t(np.stack(luts_for_dictionary(HOSTS)).astype(np.int32)))),
    }
    vals = t((rng.random(n) * 500).astype(np.float32))
    mask = t(rng.random(n) < 0.9)
    for g in (8, 128, 2048):
        out[f"uniform K6 G={g}"] = ("pct", g, 0, (vals, t(rng.integers(0, g, n).astype(np.int32)), mask))
    # skewed: every row one value in one group, and half the rows so
    skew_ids = rng.integers(0, 8, n).astype(np.int32)
    half = rng.random(n) < 0.5
    skew_ids[half] = 0
    skew_vals = (rng.random(n) * 500).astype(np.float32)
    skew_vals[half] = 300.0
    out["skewed K6 G=8, one key"] = ("pct", 8, 0, (t(np.full(n, 300.0, np.float32)),
                                                   t(np.zeros(n, np.int32)), mask))
    out["skewed K6 G=8, half one key"] = ("pct", 8, 0, (t(skew_vals), t(skew_ids), mask))
    codes = t(rng.integers(0, 100, n).astype(np.int8))
    for g, cap in ((64, 128), (2048, 128), (8, 4096), (64, 4096)):
        lut = (np.stack([rng.integers(0, cap, 100), rng.integers(1, 20, 100)]) if cap == 4096
               else rng.integers(0, cap - 1, 100))
        name = f"uniform {'HLL' if cap == 4096 else 'presence'} {g}x{cap}"
        out[name] = ("dist", g, cap, (t(rng.integers(0, g, n).astype(np.int32)), codes, mask,
                                      t(lut.astype(np.int32))))
    # K7 (ids, vals [Q, N], valid [Q, N], mask, means [Q, G]): stats_status's
    # 8 status groups, 200 on half of the rows, and uniform blocks
    def m2(q, g, ids):
        return ("m2", g, q, (t(ids), t((rng.random((q, n)) * 500).astype(np.float32)),
                             t(rng.random((q, n)) < 0.9), t(rng.random(n) < 0.9),
                             t((rng.random((q, g)) * 500).astype(np.float32))))

    out["main K7 Q=2 G=8"] = m2(2, 8, code)
    for q, g in ((1, 8), (2, 8), (1, 16), (2, 64), (3, 5000)):
        out[f"uniform K7 Q={q} G={g}"] = m2(q, g, rng.integers(0, g, n).astype(np.int32))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--blocks", default="", help="only the blocks whose names hold this")
    ap.add_argument("--json", type=Path, help="also write the times here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_stats_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from parseable_tpu_torch.ops import stats_cuda as SC

    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(pool.map(build, names))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        SC._bind(lib)
        libs[name] = lib
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def k6(lib, acc, vals, ids, mask, mode):
        err = lib.pct_histogram(vals.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                                acc.numel() // SC.DEVICE_NB, vals.numel(), SC.PCT_LO, SC.PCT_HI,
                                SC.PCT_SCALE, acc.data_ptr(), mode, stream())
        assert err == 0, err

    def k5(lib, acc, cap, ids, codes, mask, lut, mode):
        hll = lut.dim() == 2
        idx, rank = (lut[0], lut[1]) if hll else (lut, None)
        err = lib.distinct_fold(ids.data_ptr(), codes.data_ptr(), codes.element_size(),
                                mask.data_ptr(), idx.data_ptr(), rank.data_ptr() if hll else None,
                                lut.shape[-1], cap, acc.numel() // cap, codes.numel(),
                                acc.data_ptr(), mode, stream())
        assert err == 0, err

    def k7(lib, out, ids, vals, valid, mask, mean, mode):
        q, g = mean.shape
        err = lib.centered_m2(vals.data_ptr(), valid.data_ptr(), mask.data_ptr(), ids.data_ptr(),
                              mean.data_ptr(), q, g, ids.numel(), out.data_ptr(), mode, stream())
        assert err == 0, err

    timer = CS.DeviceTimer(torch)
    results = {}
    print(CS.nvidia_smi(), flush=True)
    for bname, (kind, g, cap, host) in blocks(torch, SC, args.seed).items():
        if args.blocks not in bname:
            continue
        sets = [tuple(x.cuda() for x in host) for _ in range(COPIES)]
        runs = [(v, "compact") for v in names] + [("compact", "global")]
        exact = kind != "m2"
        if kind == "m2":
            # the variants where the compact regime holds the shape, else
            # the earlier regimes against each other
            q = cap
            fits = SC.m2_regime(q, g) == "compact"
            runs = [(v, "compact") for v in names] if fits else [("compact", "global")]
            if 2 * q * g * 4 <= SC.SMEM_BUDGET:
                runs.append(("compact", "shared"))
            want = SC.centered_m2_plain(*sets[0])
            out = torch.empty_like(want)
            reset = None

            def call(v, mode, k, out=out):
                k7(libs[v], out, *sets[k], MODES[mode])

            def fresh_result(v, mode):
                a = torch.empty_like(want)
                k7(libs[v], a, *sets[0], MODES[mode])
                return a
        elif kind == "pct":
            if g * SC.DEVICE_NB * 4 <= SC.SMEM_BUDGET:
                runs.append(("compact", "shared"))
            want = SC.pct_histogram_plain(torch.zeros(g * SC.DEVICE_NB, device="cuda"), *sets[0])
            acc = torch.zeros(g * SC.DEVICE_NB, device="cuda")
            reset = None

            def call(v, mode, k, acc=acc):
                k6(libs[v], acc, *sets[k], MODES[mode])

            def fresh_result(v, mode):
                a = torch.zeros_like(want)
                k6(libs[v], a, *sets[0], MODES[mode])
                return a
        else:
            if g * cap <= SC.DISTINCT_SHARED_MAX:
                runs.append(("compact", "shared"))
            ids, codes, mask, lut = sets[0]
            want = SC.distinct_fold_plain(torch.zeros(g * cap, device="cuda"), ids, codes, mask,
                                          cap, lut)
            # each call folds into a fresh zeroed accumulator: a re-fold into
            # registers that already hold their values skips every write
            pool = [torch.zeros(g * cap, device="cuda") for _ in range(3 + 2 * CS.REPS)]
            turn = [0]

            def reset():
                for a in pool:
                    a.zero_()
                turn[0] = 0

            def call(v, mode, k):
                turn[0] += 1
                k5(libs[v], pool[(turn[0] - 1) % len(pool)], cap, *sets[k], MODES[mode])

            def fresh_result(v, mode):
                a = torch.zeros_like(want)
                k5(libs[v], a, cap, *sets[0], MODES[mode])
                return a
        for v, mode in runs:
            got = fresh_result(v, mode)
            if not (torch.equal(got, want) if exact
                    else torch.allclose(got, want, rtol=CS.REL_TOL, atol=CS.ABS_TOL)):
                raise SystemExit(f"{bname}: {v} ({mode}) differs from the plain version")
        times = {}
        for v, mode in runs + runs[::-1]:
            if reset:
                reset()
            us = timer.ms(lambda k: call(v, mode, k), COPIES) * 1e3
            times.setdefault(v if mode == "compact" else mode, []).append(round(us, 2))
        results[bname] = times
        print(f"{bname} | " + "  ".join(f"{k} {v}" for k, v in times.items()), flush=True)
    print(f"timer windows re-run {timer.reruns}, never ahead of the device {timer.dry}")
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": CS.nvidia_smi(), "us": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
