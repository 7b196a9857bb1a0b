#!/usr/bin/env python3
"""Time the device top-k (K8, `parseable_tpu_torch/csrc/topk.cu`) kernel by
kernel, on one NVIDIA card.

    python3 scripts/torch_topk_profile.py

For G = 8,192, 2^17 and 2^19 groups (an accumulator of `chip_smoke.py`'s
`topk_hazard_acc`, ORDER BY sum DESC LIMIT 10): torch.profiler's device time
a launch of each of K8's kernels (score, the radix-select pass, launched 8
times a call, compaction, sort, gather) over 10 calls, then the device time
of one call from CUDA events around 20 calls behind a device spin. Needs a
card.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from parseable_tpu_torch.ops import topk_cuda as K  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi())
    args = ("sum", 2, 1, 0, True, 10)  # value row 2, pac row 1
    for g in (8192, 1 << 17, 1 << 19):
        acc = chip_smoke.topk_hazard_acc(np, np.random.default_rng(1), 3, g, 2)
        acc = torch.from_numpy(acc).cuda()
        for _ in range(3):
            K.topk_groups(acc, *args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                K.topk_groups(acc, *args)
            torch.cuda.synchronize()
        kernels = {ev.key[ev.key.index("k8_"):].split("(")[0]:
                   (round(ev.self_device_time_total / ev.count, 3), ev.count // 10)
                   for ev in prof.key_averages() if "k8_" in ev.key}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(20):
            K.topk_groups(acc, *args)
        end.record()
        end.synchronize()
        print(f"G={g}: (us per launch, launches per call) {kernels}, us per call "
              f"{start.elapsed_time(end) / 20 * 1e3:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
