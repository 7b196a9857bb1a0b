"""Device operators for the query engine, in PyTorch.

Counterpart of `parseable_tpu/ops/kernels.py`: `lut_mask` (:38),
`masked_distinct_bitmap` (:51), `topk` (:71) and `fused_groupby_block`
(:108), with the same signatures and output shapes.
Group-by is dense: group keys arrive pre-combined into one int32 id in
[0, num_groups), filters arrive as masks, and every reduction weights by the
mask instead of compacting rows.

`masked_distinct_bitmap` runs on the distinct kernel (K5) of
`ops/stats_cuda.py`. `topk` is the plain pick of the device top-k: the
kernel K8 (`ops/topk_cuda.py`) selects on the card, and its plain version
calls this one.

`fused_groupby_block` runs one block's whole partial aggregate through the
hand kernels of `ops/groupby_cuda.py`: the additive rows (row count,
per-aggregate counts, sums) through kernel A, min/max through kernel B. On
CPU tensors the same calls compute the kernels' plain versions. The
executor's fold does not build these stacks: kernel K3b
(`ops/fold_cuda.py stack_operands`) writes A's and B's inputs from the
block's columns, and the fold calls A and B directly.
"""

from __future__ import annotations

import torch

from parseable_tpu_torch.ops.groupby_cuda import F32_MAX, additive_groupby, minmax_groupby
from parseable_tpu_torch.ops.stats_cuda import distinct_fold

__all__ = ["F32_MAX", "fused_groupby_block", "lut_mask", "masked_distinct_bitmap", "topk"]


def lut_mask(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """String predicate as a dictionary-LUT gather: lut[codes].

    The LUT is the predicate evaluated on the host over the dictionary
    values (plus a trailing False for the null slot). Codes ship in the
    narrowest integer type (int8/int16/int32); torch indexes only with
    int32/int64, so narrow codes widen here."""
    if codes.dtype != torch.int32:
        codes = codes.to(torch.int32)
    return lut[codes]


def masked_distinct_bitmap(
    group_ids: torch.Tensor,
    value_codes: torch.Tensor,
    mask: torch.Tensor,
    num_groups: int,
    num_values: int,
) -> torch.Tensor:
    """Exact per-group distinct of a dict-encoded column: presence matrix
    f32 [num_groups, num_values], 1 where a masked-in row of the group holds
    the value (codes past num_values - 1 count as num_values - 1). A cell no
    row reaches holds 0; JAX's segment_max leaves -inf there, and both read
    presence as > 0."""
    if group_ids.dtype != torch.int32:
        group_ids = group_ids.to(torch.int32)
    acc = torch.zeros(num_groups * num_values, dtype=torch.float32, device=mask.device)
    return distinct_fold(acc, group_ids, value_codes, mask, num_values).view(num_groups, num_values)


def topk(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a 1-D tensor -> (values [k], indices int64 [k]), largest
    first and, as `lax.top_k`, the lower index first among equal values: a
    stable descending sort keeps equal values in index order. For int32
    scores (the device top-k's) and floats without NaN."""
    order = torch.sort(values, descending=True, stable=True).indices[:k]
    return values[order], order


def fused_groupby_block(
    group_ids: torch.Tensor,  # int32 [N] in [0, num_groups)
    mask: torch.Tensor,  # bool [N]
    sum_values: torch.Tensor,  # float32 [n_sum, N]
    min_values: torch.Tensor,  # float32 [n_min, N]
    max_values: torch.Tensor,  # float32 [n_max, N]
    valid: torch.Tensor,  # bool [n_all, N] per-agg-input validity
    num_groups: int,
    n_sum: int,
    n_min: int,
    n_max: int,
):
    """One block's complete partial aggregate.

    Returns (count[G], per_agg_count[n_all, G], sums[n_sum, G],
    mins[n_min, G], maxs[n_max, G]). Validity rows are ordered
    [sum inputs | min inputs | max inputs | count-only inputs].

    Precision: counts accumulate in f32 and are exact below 2^24 per block;
    sums are f32 adds (no TF32, no bf16). A masked-off row contributes
    +-3.4e38 to min/max; a group no row reaches gives +-inf, as JAX's
    segment_min/segment_max identities do.
    """
    if group_ids.dtype != torch.int32:
        group_ids = group_ids.to(torch.int32)
    n_all = valid.shape[0]
    vmask = valid & mask[None, :]
    rows = torch.cat(
        [
            mask[None, :].to(torch.float32),
            vmask.to(torch.float32),
            torch.where(vmask[:n_sum], sum_values, 0.0),
        ],
        dim=0,
    )
    adds = additive_groupby(group_ids, rows, num_groups)
    count, per_agg_count, sums = adds[0], adds[1 : 1 + n_all], adds[1 + n_all :]
    if n_min + n_max:
        mins, maxs = minmax_groupby(
            group_ids,
            torch.cat([min_values, max_values], dim=0).contiguous(),
            valid[n_sum : n_sum + n_min + n_max].contiguous(),
            mask.contiguous(),
            num_groups,
            n_min,
        )
    else:
        mins = maxs = torch.zeros((0, num_groups), dtype=torch.float32, device=mask.device)
    return count, per_agg_count, sums, mins, maxs
