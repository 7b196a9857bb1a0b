#!/usr/bin/env python3
"""Time design variants of the block-local fold's two "global" kernels, A
(`additive_groupby`) and K7 (`centered_m2`), on one NVIDIA card, in turns.

    python3 scripts/torch_local_fold_variants.py [--parent DIR] [--variants a_rows,k7_record]
                                                  [--no-lake] [--json out.json]

Designs timed on each case, each a call of the C entry on preallocated
outputs:
- A `record`: the source's fold into its group-major record
  [G, record_width(R)] alone; `record+rows`: with the launch that lays the
  record out as [R, G] (what the wrapper returns); `record+copy`: the fold,
  then torch's contiguous copy of the record's [R, G] view instead;
- K7 `source`: the source's "global" regime; `library`: the same function
  in torch ops from K7's own inputs, the mean's gather, the mask, the
  square and `index_add_` all inside the timed window (timed only);
- `parent`: the "global" kernels of `DIR/groupby.cu` and `DIR/stats.cu`
  (e.g. `git archive <commit> parseable_tpu_torch/csrc` unpacked), with the
  interface they had;
- each of `--variants` (VARIANTS): the source with a few lines replaced.
  Diagnostic variants compute another function and are timed only.

Cases: the A and K7 calls of `chip_smoke.py`'s phase-10 queries (its
highcard lake, 8 files of 2^20 rows, built and queried once on the "gpu"
engine; `--no-lake` skips them), then uniform ids at G = 2^17, 2^20 and
2^22 (A at R = 3 and 4, K7 at Q = 1). Every other design is checked
against the plain version (A: counts exact, sums rel 2e-4 of f64; K7
`m2_close`), then each is timed device-only (`chip_smoke.DeviceTimer`,
L2-cold over input copies that exceed L2) in turns, first to last and
back. Bounds as in chip_smoke.py: inputs read once, outputs written once.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "parseable_tpu_torch" / "csrc"
OUT = ROOT / "build" / "local_fold_variants"

# variant -> (source file, [(text, its replacement)], how it is called)
VARIANTS = {
    # A: the fold at 32 registers (4 CTAs of 512 an SM; ptxas spills)
    "a_ctas4": ("groupby.cu", [("constexpr int kGlobalCtas = 2;", "constexpr int kGlobalCtas = 4;")],
                "record+rows"),
    # A: the same fold into [R, G], one scalar atomic a nonzero value
    "a_rows": ("groupby.cu", [
        ("const Peers& peers, bool lead, int R) {", "const Peers& peers, bool lead, int R, int G) {"),
        ("fold_chunk(record, g[e], c, x, peers, lead, R);",
         "fold_chunk(record, g[e], c, x, peers, lead, R, G);"),
        ("    red_add4(record + (long long)g * record_width(R) + c, x[0], x[1], x[2], x[3]);",
         "    for (int k = 0; k < 4 && c + k < R; ++k) {\n"
         "      if (x[k] != 0.f) atomicAdd(record + (long long)(c + k) * G + g, x[k]);\n"
         "    }")], "rows"),
    # A: the rows read with cached loads (ld.global.nc) instead of evict-first
    "a_ldg": ("groupby.cu", [("constexpr bool kGlobalStream = true;",
                              "constexpr bool kGlobalStream = false;")], "record+rows"),
    # K7: mean and sum of squares of a group in one sector, a [G, 2Q] record
    # built outside the timed window (its build is not timed)
    "k7_record": ("stats.cu", [
        ("__ldcg(mean + (long long)p * G + g[k]) : 0.f;",
         "__ldcg(mean + (long long)g[k] * 2 * Q + p) : 0.f;"),
        ("if (lead && d2 != 0.f) atomicAdd(out + (long long)p * G + g[k], d2);",
         "if (lead && d2 != 0.f) atomicAdd(out + (long long)g[k] * 2 * Q + Q + p, d2);"),
        ("cudaError_t err = cudaMemsetAsync(out, 0, (size_t)Q * G * sizeof(float), s);",
         "cudaError_t err = cudaSuccess;")], "k7_record"),
    # K7 diagnostics: no gather of the mean; no atomic
    "k7_nogather": ("stats.cu", [(
        "mu[p][k] = p < Q && g[k] >= 0 && ok[p][k] ? __ldcg(mean + (long long)p * G + g[k]) : 0.f;",
        "mu[p][k] = 0.f;")], "diagnostic"),
    "k7_noatomic": ("stats.cu", [(
        "if (lead && d2 != 0.f) atomicAdd(out + (long long)p * G + g[k], d2);",
        "if (lead && d2 == 1.5e-30f) out[g[k]] = d2;")], "diagnostic"),
}


def build(name: str, source: str, text: str, headers: Path) -> ctypes.CDLL:
    """`text` as `source`, with the `common.cuh` of `headers`, compiled into
    build/local_fold_variants/<name>-<source stem>/ and loaded."""
    from parseable_tpu_torch.ops import cuda_lib

    d = OUT / f"{name}-{Path(source).stem}"
    d.mkdir(parents=True, exist_ok=True)
    (d / source).write_text(text)
    shutil.copy(headers / "common.cuh", d / "common.cuh")
    lib = d / f"lib{Path(source).stem}.so"
    cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(d / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {name} {source}:\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if source == "groupby.cu":
        # the parent's entry had no record argument
        so.additive_groupby.argtypes = [p, p, p, i, ll, i, i, p] if name == "parent" else [
            p, p, p, p, i, ll, i, i, p]
        so.additive_groupby.restype = i
    else:
        so.centered_m2.argtypes = [p, p, p, p, p, i, i, ll, p, i, p]
        so.centered_m2.restype = i
    return so


def variant_text(name: str) -> tuple[str, str]:
    source, edits, _ = VARIANTS[name]
    text = (CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{source} holds no `{old}` to vary")
        text = text.replace(old, new)
    return source, text


def record_phase10(torch, seed: int) -> list:
    """The first A and K7 call of each phase-10 query at each shape, inputs
    cloned: [(label, kernel, args)]."""
    import chip_smoke
    from parseable_tpu_torch.ops import groupby_cuda as G
    from parseable_tpu_torch.ops import stats_cuda as SC
    from parseable_tpu_torch.ops.enccache import shutdown_enccache
    from parseable_tpu_torch.ops.hotset import get_hotset
    from parseable_tpu_torch.query.session import QuerySession

    work = ROOT / "build" / "local_fold_variants_lake"
    shutil.rmtree(work, ignore_errors=True)
    calls: dict = {}
    current = [None]
    real_a, real_k7 = G.additive_groupby, SC.centered_m2

    def rec_a(ids, rows, g, **kw):
        calls.setdefault((current[0], "A", rows.shape[0], g), ("A", (ids.clone(), rows.clone(), g)))
        return real_a(ids, rows, g, **kw)

    def rec_k7(ids, vals, valid, mask, mean, **kw):
        calls.setdefault((current[0], "K7", vals.shape[0], mean.shape[1]),
                         ("K7", tuple(t.clone() for t in (ids, vals, valid, mask, mean))))
        return real_k7(ids, vals, valid, mask, mean, **kw)

    p = None
    try:
        p = chip_smoke.build_lake(work, seed + 10, chip_smoke.HC_MINUTES, chip_smoke.N_BLOCK,
                                  chip_smoke.HC_STREAM, chip_smoke.make_hc_minute, "variants")
        G.additive_groupby, SC.centered_m2 = rec_a, rec_k7
        for qname, (sql, _, _) in chip_smoke.HC_QUERIES.items():
            current[0] = qname
            get_hotset().clear()
            QuerySession(p, engine="gpu").query(sql.format(stream=chip_smoke.HC_STREAM))
    finally:
        G.additive_groupby, SC.centered_m2 = real_a, real_k7
        if p is not None:
            p.shutdown()
        get_hotset().clear()
        shutdown_enccache()
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    return [(f"{q} {k} R/Q={rq} G={g}", kind, args)
            for (q, k, rq, g), (kind, args) in calls.items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory holding the parent's groupby.cu and stats.cu")
    ap.add_argument("--variants", default="", help=f"comma-separated, of {', '.join(VARIANTS)}")
    ap.add_argument("--no-lake", action="store_true", help="skip the phase-10 cases")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--json", help="write the results here too")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from parseable_tpu_torch.ops import groupby_cuda as G
    from parseable_tpu_torch.ops import stats_cuda as SC

    print(chip_smoke.nvidia_smi(), flush=True)
    # (design, source, text, headers), built by one nvcc each, all at once
    jobs = [("source", s, (CSRC / s).read_text(), CSRC) for s in ("groupby.cu", "stats.cu")]
    if args.parent:
        parent = Path(args.parent)
        jobs += [("parent", s, (parent / s).read_text(), parent) for s in ("groupby.cu", "stats.cu")]
    jobs += [(v, *variant_text(v), CSRC) for v in filter(None, args.variants.split(","))]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    libs_a = {j[0]: lib for j, lib in zip(jobs, built) if j[1] == "groupby.cu"}
    libs_k7 = {j[0]: lib for j, lib in zip(jobs, built) if j[1] == "stats.cu"}

    gen = torch.Generator().manual_seed(args.seed)
    cases = record_phase10(torch, args.seed) if not args.no_lake else []
    for g in (1 << 17, 1 << 20, 1 << 22):
        for r in (3, 4):
            cases.append((f"uniform A R/Q={r} G={g}", "A",
                          (*chip_smoke.uniform_a(torch, r, chip_smoke.N_BLOCK, g, gen), g)))
        key = (1, chip_smoke.N_BLOCK, g)
        data = chip_smoke.stats_inputs(torch, SC, "centered_m2", key, gen)
        cases.append((f"uniform K7 R/Q=1 G={g}", "K7", tuple(t.cuda().contiguous() for t in data)))
    timer = chip_smoke.DeviceTimer(torch)

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    results = {}
    for label, kind, data in cases:
        if kind == "A":
            ids, rows, g = data
            r, n = rows.shape
            nbytes = 4 * n * (r + 1) + 4 * r * g
            copies = chip_smoke.n_copies(nbytes)
            sets = [(ids, rows)] + [(ids.clone(), rows.clone()) for _ in range(copies - 1)]
            record = torch.empty((g, G.record_width(r)), device="cuda")
            flat = torch.empty((r, g), device="cuda")
            plain = G.additive_groupby_plain(ids, rows, g)

            def call(name, k):
                lib = libs_a["source" if name.startswith("record") else name]
                how = VARIANTS[name][2] if name in VARIANTS else name
                i, x = sets[k]
                if name == "parent":
                    err = lib.additive_groupby(i.data_ptr(), x.data_ptr(), flat.data_ptr(), r, n, g,
                                               2, stream())
                else:
                    out = flat.data_ptr() if how == "record+rows" else None
                    err = lib.additive_groupby(i.data_ptr(), x.data_ptr(), record.data_ptr(), out,
                                               r, n, g, 2, stream())
                if err:
                    raise SystemExit(f"{label} {name}: CUDA error {err}")
                if how == "record+copy":
                    return record[:, :r].T.contiguous()
                if how in ("parent", "record+rows"):
                    return flat
                if how == "rows":
                    return record.view(-1)[: r * g].view(r, g)
                return record[:, :r].T

            def check(name):
                chip_smoke.check_additive(torch, ids, rows, g, call(name, 0), plain, f"{label} {name}")

            names = [d for d in ("parent", "record", "record+rows", "record+copy") if d != "parent"
                     or "parent" in libs_a] + [v for v in libs_a if v not in ("source", "parent")]
        else:
            ids, vals, valid, mask, mean = data
            q, n = vals.shape
            g = mean.shape[1]
            nbytes = n * (4 + 1 + 5 * q) + 2 * q * g * 4
            copies = chip_smoke.n_copies(nbytes)
            sets = [data] + [tuple(t.clone() for t in data) for _ in range(copies - 1)]
            # k7_record's records (means, then zeroed sums of squares), built here
            records = [torch.cat([s[4], torch.zeros_like(s[4])]).T.contiguous() for s in sets]
            flat = torch.empty((q, g), device="cuda")
            plain = SC.centered_m2_plain(ids, vals, valid, mask, mean)

            def call(name, k):
                i, v, ok, m, mu = sets[k]
                out = flat
                if name == "library":
                    d = torch.where(ok & m[None], v - mu[:, i], 0.0)
                    return out.index_add_(1, i, d * d)
                if name == "k7_record":
                    mu = out = records[k]
                err = libs_k7[name].centered_m2(v.data_ptr(), ok.data_ptr(), m.data_ptr(),
                                                i.data_ptr(), mu.data_ptr(), q, g, n,
                                                out.data_ptr(), 1, stream())
                if err:
                    raise SystemExit(f"{label} {name}: CUDA error {err}")
                return records[k][:, q:].T if name == "k7_record" else flat

            def check(name):
                if name == "k7_record":
                    records[0][:, q:] = 0.0
                if not chip_smoke.m2_close(torch, call(name, 0), plain):
                    raise SystemExit(f"{label} {name}: K7 disagrees with its plain version")

            names = [*libs_k7, "library"]
        for name in names:
            if VARIANTS.get(name, (0, 0, ""))[2] != "diagnostic" and name != "library":
                check(name)
        torch.cuda.synchronize()
        times: dict[str, list] = {d: [] for d in names}
        for name in names + names[::-1]:
            times[name].append(round(timer.ms(lambda k, name=name: call(name, k), copies) * 1e3, 3))
        bound = chip_smoke.bound_ms(nbytes, 0)[0] * 1e3
        res = {"case": label, "bound_us": round(bound, 3), "copies": copies, "us_in_turns": times}
        results[label] = res
        print(json.dumps(res), flush=True)
    print(f"timer windows re-run {timer.reruns}, never ahead {timer.dry}")
    print(chip_smoke.nvidia_smi())
    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
