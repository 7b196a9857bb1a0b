#!/usr/bin/env python3
"""Time the device top-k (K8, `parseable_tpu_torch/csrc/topk.cu`) on one
NVIDIA card, in turns against another commit's K8.

    python3 scripts/torch_topk_profile.py [--parent DIR] [--variants match,nocut]
                                          [--no-lake] [--json out.json]

Cases: the K8 calls of `chip_smoke.py`'s topk_multicol (its phase-3 lake,
G = 8,192) and hc_topk_path (its phase-10 highcard lake, G = 2^17),
recorded from one "gpu" run of each query (`--no-lake` skips them); then
`chip_smoke.topk_hazard_acc` accumulators (R = 3, ORDER BY sum DESC) at
G = 8,192, 2^17 and 2^19 with k = 10, and at G = 2^17 with k =
TOPK_BLOCK_MAX_K, TOPK_BLOCK_MAX_K + 1 and TOPK_MAX_K (the regime edge and
the largest k).

Designs timed on each case:
- `block`, `radix`: the source's two regimes, each where it takes k
  (`topk_regime` names the one the rule picks);
- `parent`: the `topk_groups` of `DIR/ops/topk_cuda.py` built from
  `DIR/csrc/topk.cu`, DIR an unpacked `git archive <commit>
  parseable_tpu_torch/csrc parseable_tpu_torch/ops/topk_cuda.py`'s
  `parseable_tpu_torch`;
- each of `--variants` (VARIANTS): the source's block regime with a few
  lines of `topk.cu` replaced; diagnostic variants compute another
  function and are timed only;
- `library`: torch.topk of the plain int32 scores and one index_select
  (timed only: torch.topk promises no order among ties).
Every other design is checked against `topk_groups_plain` bit for bit,
then each is timed device-only (`chip_smoke.DeviceTimer`, L2-cold over
input copies that exceed L2 threefold) in turns, first to last and back.
torch.profiler gives each design's K8 kernels (`k8_`): device us a launch
and launches a call, over 10 calls. An empty kernel's launch under the same
timer is the floor of a one-launch design. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

OUT = ROOT / "build" / "topk_profile"
CSRC = ROOT / "parseable_tpu_torch" / "csrc"

# variant -> ([(text of topk.cu, its replacement)], "design" or "diagnostic")
VARIANTS = {
    # CTAs of 256 threads (the grid as the wrapper sizes it)
    "threads256": ([("constexpr int kBlockThreads = 512;", "constexpr int kBlockThreads = 256;")],
                   "design"),
    # the cut's histograms fold a warp's equal bytes with __match_any_sync first
    "match": ([("      if (word(p, w) && (w & c.mask) == c.prefix) "
                "atomicAdd(&sh.hist[(w >> shift) & 0xFFu], 1u);\n    }\n",
                "    }\n    for (int base = (int)threadIdx.x - lane; base < n; base += blockDim.x) {\n"
                "      const int q = base + lane;\n"
                "      unsigned w = 0u;\n"
                "      int bin = -1;\n"
                "      if (q < n && word(q, w) && (w & c.mask) == c.prefix) bin = (int)((w >> shift) & 0xFFu);\n"
                "      const unsigned peers = __match_any_sync(kFull, bin);\n"
                "      if (bin >= 0 && (peers & ((1u << lane) - 1u)) == 0u) "
                "atomicAdd(&sh.hist[bin], (unsigned)__popc(peers));\n    }\n"),
               ("    for (int p = threadIdx.x; p < n; p += blockDim.x) {\n      unsigned w;\n",
                "    for (int p = n; p < n; ++p) {\n      unsigned w;\n")], "design"),
    # the merge loads its candidates with a load a step instead of cp.async
    "noasync": ([("  for (int i = threadIdx.x; i < total / 2; i += blockDim.x) {\n"
                  "    cp_async16(s_key + 2 * i, cand + 2 * i);\n  }\n",
                  "  for (int i = threadIdx.x; i < total; i += blockDim.x) s_key[i] = __ldcg(cand + i);\n"),
                 ("  if ((total & 1) && threadIdx.x == 0) s_key[total - 1] = __ldcg(cand + total - 1);\n",
                  "")], "design"),
    # diagnostic: each CTA takes its slice's first min(k, slice) groups, no cut
    "nocut": ([("block_take(score_word, n, block_cut(score_word, n, m, sh), sh,",
                "block_take(score_word, n, Cut{0u, 0u, (unsigned)m}, sh,")], "diagnostic"),
    # diagnostic: no merge; the last CTA only resets the ticket
    "nomerge": ([("  if (!sh.last) return;\n",
                  "  if (sh.last && threadIdx.x == 0) *ticket = 0u;\n  return;\n")], "diagnostic"),
}
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def load_parent(parent: Path):
    """The parent's topk_cuda module, its library built from its own csrc."""
    from parseable_tpu_torch.ops.cuda_lib import CudaLibrary

    spec = importlib.util.spec_from_file_location("parent_topk_cuda", parent / "ops" / "topk_cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LIBRARY = CudaLibrary(str(parent / "csrc" / "topk.cu"), mod._bind)
    return mod


def variant_library(name: str, bind):
    """`topk.cu` with VARIANTS[name]'s lines replaced, as a library of its own."""
    from parseable_tpu_torch.ops.cuda_lib import CudaLibrary

    text = (CSRC / "topk.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if old not in text:
            raise SystemExit(f"topk.cu holds no `{old}` to vary")
        text = text.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "topk.cu").write_text(text)
    shutil.copy(CSRC / "common.cuh", d / "common.cuh")
    return CudaLibrary(str(d / "topk.cu"), bind)


def empty_launcher(torch):
    """A launch of an empty kernel, built with nvcc here."""
    from parseable_tpu_torch.ops import cuda_lib

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "empty.cu", OUT / "libempty.so"
    src.write_text(EMPTY_SRC)
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on the empty kernel:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    so.empty_launch.argtypes = [ctypes.c_void_p]
    so.empty_launch.restype = ctypes.c_int
    return lambda _k: so.empty_launch(torch.cuda.current_stream().cuda_stream)


def record_lake_calls(torch, seed: int) -> list:
    """K8's first call in topk_multicol and in hc_topk_path, accumulator
    cloned: [(label, acc, (kind, val, pac, sq, desc, k))]."""
    from parseable_tpu_torch.ops import topk_cuda as K
    from parseable_tpu_torch.ops.enccache import shutdown_enccache
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.session import QuerySession

    recorded: dict = {}
    current = [None]
    real = K.topk_groups

    def rec(acc, *args, **kw):
        recorded.setdefault(current[0], (acc.clone(), args))
        return real(acc, *args, **kw)

    lakes = (
        ("topk_multicol", chip_smoke.QUERIES["topk_multicol"], chip_smoke.STREAM,
         (seed, chip_smoke.MINUTES, chip_smoke.N_BLOCK)),
        ("hc_topk_path", chip_smoke.HC_QUERIES["hc_topk_path"][0], chip_smoke.HC_STREAM,
         (seed + 10, chip_smoke.HC_MINUTES, chip_smoke.N_BLOCK, chip_smoke.HC_STREAM,
          chip_smoke.make_hc_minute, "topk profile")),
    )
    for qname, sql, stream, lake_args in lakes:
        work = ROOT / "build" / "topk_profile_lake"
        shutil.rmtree(work, ignore_errors=True)
        p = None
        try:
            p = chip_smoke.build_lake(work, *lake_args)
            current[0] = qname
            K.topk_groups = rec
            get_hotset().clear()
            QuerySession(p, engine="gpu").query(sql.format(stream=stream))
        finally:
            K.topk_groups = real
            if p is not None:
                p.shutdown()
            get_hotset().clear()
            shutdown_enccache()
            shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    return [(f"{q} (its own accumulator)", acc, args) for q, (acc, args) in recorded.items()]


def with_library(K, lib, acc, call_args):
    """The block regime of `K.topk_groups` on another build of `topk.cu`."""
    saved, K.LIBRARY = K.LIBRARY, lib
    try:
        return K.topk_groups(acc, *call_args, regime="block")
    finally:
        K.LIBRARY = saved


def launches_per_call(torch, fn, calls: int = 10) -> tuple[float | None, float]:
    """(device us a K8 launch, K8 launches a call) from torch.profiler."""
    us, seen = chip_smoke.profiled_ms(torch, fn, ("k8_",), calls)
    return (None if us is None else round(us * 1e3, 3)), seen / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent's parseable_tpu_torch (csrc/topk.cu, ops/topk_cuda.py)")
    ap.add_argument("--variants", default="", help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--no-lake", action="store_true", help="skip the two queries' accumulators")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--json", help="write the results here too")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from parseable_tpu_torch.ops import topk_cuda as K

    print(chip_smoke.nvidia_smi(), flush=True)
    parent = load_parent(Path(args.parent).resolve()) if args.parent else None
    variants = {v: variant_library(v, K._bind) for v in filter(None, args.variants.split(","))}
    libs = [K.LIBRARY] + ([parent.LIBRARY] if parent else []) + list(variants.values())
    from parseable_tpu_torch.ops.cuda_lib import build_all

    print(f"built K8 libraries in {build_all(libs):.1f} s", flush=True)
    empty = empty_launcher(torch)
    timer = chip_smoke.DeviceTimer(torch)

    cases = record_lake_calls(torch, args.seed) if not args.no_lake else []
    for g, k in ((8192, 10), (1 << 17, 10), (1 << 19, 10), (1 << 17, K.TOPK_BLOCK_MAX_K),
                 (1 << 17, K.TOPK_BLOCK_MAX_K + 1), (1 << 17, K.TOPK_MAX_K)):
        acc = chip_smoke.topk_hazard_acc(np, np.random.default_rng(g), 3, g, 2)
        cases.append((f"hazard R=3 G={g} k={k}", torch.from_numpy(acc).cuda(),
                      ("sum", 2, 1, 0, True, k)))

    results = {"empty_launch_us": [round(timer.ms(empty) * 1e3, 3)]}
    for label, acc, call_args in cases:
        kind, val, pac, sq, desc, k = call_args
        r, g = acc.shape
        read = {0, pac, val} | ({sq} if kind in ("var", "stddev") else set())
        nbytes = 4 * g * len(read) + 2 * 4 * r * k + 4 * k
        copies = chip_smoke.n_copies(nbytes)
        sets = [acc] + [acc.clone() for _ in range(copies - 1)]
        scores = [K.scores_plain(a, kind, val, pac, sq, desc) for a in sets]
        fns = {}
        if parent:
            fns["parent"] = lambda j: parent.topk_groups(sets[j], *call_args)
        for regime in K.REGIMES:
            if regime != "block" or k <= K.TOPK_BLOCK_MAX_K:
                fns[regime] = lambda j, regime=regime: K.topk_groups(sets[j], *call_args,
                                                                      regime=regime)
        for name, lib in variants.items() if k <= K.TOPK_BLOCK_MAX_K else ():
            fns[name] = lambda j, lib=lib: with_library(K, lib, sets[j], call_args)
        fns["library"] = lambda j: sets[j].index_select(1, torch.topk(scores[j], k).indices)
        pout, pidx = K.topk_groups_plain(acc, *call_args)
        for name, fn in fns.items():
            if name != "library" and VARIANTS.get(name, ([], "design"))[1] == "design":
                out, idx = fn(0)
                if not (torch.equal(idx, pidx) and torch.equal(out.view(torch.int32),
                                                                 pout.view(torch.int32))):
                    raise SystemExit(f"{label} {name}: K8 disagrees with its plain version")
        names = list(fns)
        times: dict[str, list] = {n: [] for n in names}
        for name in names + names[::-1]:
            times[name].append(round(timer.ms(fns[name], copies) * 1e3, 3))
        profiled = {n: launches_per_call(torch, fns[n]) for n in names
                    if n in ("parent", *K.REGIMES)}
        res = {
            "case": label, "shape": f"R={r} G={g} k={k} {kind} {'desc' if desc else 'asc'}",
            "rule": K.topk_regime(g, k), "bound_us": round(chip_smoke.bound_ms(nbytes, 8 * g)[0] * 1e3, 3),
            "copies": copies, "us_in_turns": times,
            "profiler_us_a_launch_and_launches_a_call": profiled,
        }
        results[label] = res
        print(json.dumps(res), flush=True)
    results["empty_launch_us"].append(round(timer.ms(empty) * 1e3, 3))
    print(json.dumps({"empty_launch_us": results["empty_launch_us"]}))
    print(f"timer windows re-run {timer.reruns}, never ahead {timer.dry}")
    print(chip_smoke.nvidia_smi())
    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
