"""parseable_tpu_torch — the observability data lake on PyTorch and CUDA.

A port of the JAX package `parseable_tpu/` to one NVIDIA H100. It covers
the path users run most, as one node: JSON events in over HTTP
(`server/app.py`) -> flatten and schema inference (`event/`) -> Arrow-IPC
staging (`streams.py`, `staging/`) -> Parquet -> the local lake's
manifest + snapshot catalog (`core.py`), and a time-bounded `GROUP BY`
aggregate over staging and the lake answered by
`QuerySession(p).query(...)`. Each scanned block is encoded on the host,
shipped to the card in one copy, masked and grouped with plain tensor
code, and reduced by the hand-written group-by kernels in
`csrc/groupby.cu` (see `ops/groupby_cuda.py`); stddev/var, approximate
percentiles, count(distinct) and approx_distinct fold through the
statistics kernels in `csrc/stats.cu` (see `ops/stats_cuda.py`).

Module paths and public names follow the JAX package, so the counterpart of
`parseable_tpu/query/planner.py` is `parseable_tpu_torch/query/planner.py`.
The package keeps its own copy of every module it needs; it shares no code
with the JAX package. The lake layout (stream JSON, schema, manifests,
Parquet keys) is identical, so each package reads the other's lake.
"""

__version__ = "0.1.0"

# Reserved column added to every event
DEFAULT_TIMESTAMP_KEY = "p_timestamp"

# Sync interval (seconds): arrows flush -> parquet conversion. Queries whose
# upper bound lies within two of these of "now" may touch staging data.
LOCAL_SYNC_INTERVAL = 60
# minutes per object-store prefix slot
OBJECT_STORE_DATA_GRANULARITY = 1
