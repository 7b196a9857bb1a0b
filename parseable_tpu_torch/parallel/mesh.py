"""Distributed query execution over a mesh of CUDA devices.

Counterpart of `parseable_tpu/parallel/mesh.py` (:33-193). The JAX package
runs its mesh single-controller: one process, one executor, N devices under
`shard_map`. So does the port: one process over a list of devices.

- rows (the time/sequence axis of a log store) shard contiguously over the
  `data` axis (`shard_rows`, JAX's `P("data")`); each device folds its row
  shard with the same hand kernels the single-device path uses (A and B
  through `ops/kernels.fused_groupby_block`);
- the partials are copied to the mesh's first device (or, on the 2D layout,
  to the first device of each groups column) and ONE hand kernel there,
  K10 `mesh_combine` (`ops/mesh_cuda.py`), combines them by sum, min, max
  and Chan's recentre, where JAX runs psum / pmin / pmax over ICI;
- on the 2D layout (`make_mesh_2d`, axes ("data", "groups")) the group
  space shards too: the devices of groups column g own the contiguous
  window [g * G / M, (g + 1) * G / M); rows outside it mask off, ids shift
  into it, and only the data axis combines.

A mesh's device list may name one device several times: the virtual mesh.
Its shards are then views of one tensor and its copies no-ops; the tests
run it on the CPU (against the JAX package's 8-device CPU mesh) and
`chip_smoke.py` on one card. `pin_mesh` makes one mesh what the GPU
executor's `resolve_mesh` returns, the way `ops/link.py pin_link` pins a
link profile.

Used by: `query/executor_cuda.py` (when a mesh resolves), tests and
`chip_smoke.py`.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Sequence

import torch

from parseable_tpu_torch.ops import kernels, mesh_cuda

__all__ = [
    "Mesh", "RowShards", "combine", "distributed_groupby", "distributed_groupby_2d",
    "full_query_step", "make_mesh", "make_mesh_2d", "pin_mesh", "pinned_mesh", "shard_rows",
]


def _device(d: torch.device | str) -> torch.device:
    """A device with its index: "cuda" names the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices laid out row-major over named axes, as `jax.sharding.Mesh`:
    `devices` (position p = d * n_groups + g on the 2D layout), `axis_names`
    (("data",) or ("data", "groups")), `shape` (axis -> size) and `size`.
    Position p holds row shard `data_index(p)` and, on the 2D layout, group
    window `group_index(p)`."""

    def __init__(self, devices: Sequence[torch.device | str], axis_names: tuple[str, ...],
                 shape: tuple[int, ...]):
        if len(axis_names) != len(shape) or not 1 <= len(shape) <= 2:
            raise ValueError(f"a mesh has one or two axes, not {axis_names} x {shape}")
        if any(s < 1 for s in shape) or len(devices) != _prod(shape):
            raise ValueError(f"{len(devices)} devices do not fill a {shape} mesh")
        self.devices = [_device(d) for d in devices]
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"a mesh's devices are all CUDA or all CPU: {kinds}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = len(self.devices)

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_groups(self) -> int:
        return self.shape.get("groups", 1)

    @property
    def one_device(self) -> bool:
        """Every position on one device (a virtual mesh)."""
        return len(set(self.devices)) == 1

    def data_index(self, p: int) -> int:
        return p // self.n_groups

    def group_index(self, p: int) -> int:
        return p % self.n_groups

    def column(self, g: int) -> list[int]:
        """The positions of groups column g, in data order."""
        return [d * self.n_groups + g for d in range(self.n_data)]

    def held(self) -> dict[torch.device, list[int]]:
        """Per distinct device (in order of first position): the row shards
        its positions hold, ascending."""
        out: dict[torch.device, list[int]] = {}
        for p, dev in enumerate(self.devices):
            shards = out.setdefault(dev, [])
            if self.data_index(p) not in shards:
                shards.append(self.data_index(p))
        return {dev: sorted(s) for dev, s in out.items()}

    @property
    def placement(self) -> tuple:
        """What a row-sharded block's layout depends on."""
        return tuple(str(d) for d in self.devices), tuple(self.shape.items())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def _prod(shape: tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _visible(n: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(f"a mesh of {n} devices, but {have} CUDA devices are visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = "data",
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A 1D mesh over the first `n_devices` visible CUDA devices (all of
    them by default), or over `devices`, which may repeat a device."""
    if devices is None:
        n = n_devices if n_devices is not None else torch.cuda.device_count()
        devices = _visible(n)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(list(devices), (axis,), (len(devices),))


def make_mesh_2d(n_data: int, n_groups: int,
                 devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """A (data x groups) mesh over the first n_data * n_groups visible CUDA
    devices, or over `devices` (row-major)."""
    n = n_data * n_groups
    devices = _visible(n) if devices is None else list(devices)[:n]
    return Mesh(devices, ("data", "groups"), (n_data, n_groups))


# ------------------------------------------------------------------ pinning

_PINNED: Mesh | None = None


@contextmanager
def pin_mesh(mesh: Mesh):
    """Make `mesh` what every `executor_cuda.resolve_mesh` call returns until
    the block exits, whatever `P_TPU_MESH` says: the injection point of a
    virtual mesh for tests and `chip_smoke.py`. Pins do not nest."""
    global _PINNED
    if _PINNED is not None:
        raise RuntimeError("a mesh is already pinned")
    _PINNED = mesh
    try:
        yield mesh
    finally:
        _PINNED = None


def pinned_mesh() -> Mesh | None:
    return _PINNED


# ------------------------------------------------------------ row sharding


class RowShards(list):
    """A tensor row-sharded over a mesh: per position its contiguous row
    shard of the data axis (the last dimension), on the position's device;
    positions on one device holding one shard share one tensor."""


def shard_rows(mesh: Mesh, *tensors: torch.Tensor) -> tuple[RowShards, ...]:
    """Place [N] / [R, N] tensors row-sharded over the data axis (JAX
    `P("data")` / `P(None, "data")`), replicated over the groups axis."""
    out = []
    for t in tensors:
        n = t.shape[-1]
        if n % mesh.n_data:
            raise ValueError(f"{n} rows do not split over a data axis of {mesh.n_data}")
        rows = n // mesh.n_data
        made: dict[tuple, torch.Tensor] = {}
        shards = RowShards()
        for p, dev in enumerate(mesh.devices):
            d = mesh.data_index(p)
            key = (dev, d)
            if key not in made:
                made[key] = t[..., d * rows : (d + 1) * rows].to(dev).contiguous()
            shards.append(made[key])
        out.append(shards)
    return tuple(out)


def _shards(mesh: Mesh, x) -> RowShards:
    return x if isinstance(x, RowShards) else shard_rows(mesh, x)[0]


# ----------------------------------------------------------------- combine


def combine(partials: Sequence[torch.Tensor], desc: Sequence[tuple[int, int, int]],
            head: torch.device) -> torch.Tensor:
    """Copy the D shards' partials f32 [R, W] to `head`, stack them [D, R,
    W] and combine them with K10. A copy between two cards is a plain
    `copy_`, which runs on the source card's stream between two events: the
    destination's stream waits for the copy before K10 reads it."""
    first = partials[0]
    parts = torch.empty((len(partials), *first.shape), dtype=torch.float32, device=head)
    for d, x in enumerate(partials):
        parts[d].copy_(x, non_blocking=True)
    return mesh_cuda.mesh_combine(parts, desc)


def _block_desc(n_add: int, n_min: int, n_max: int) -> list[tuple[int, int, int]]:
    return ([(mesh_cuda.SUM, 0, 0)] * n_add + [(mesh_cuda.MIN, 0, 0)] * n_min
            + [(mesh_cuda.MAX, 0, 0)] * n_max)


def _partial(count, pac, sums, mins, maxs) -> torch.Tensor:
    return torch.cat([count[None, :], pac, sums, mins, maxs], dim=0)


def _split(out: torch.Tensor, n_all: int, n_sum: int, n_min: int):
    a = 1 + n_all
    b = a + n_sum
    return out[0], out[1:a], out[a:b], out[b : b + n_min], out[b + n_min :]


def distributed_groupby(mesh: Mesh, num_groups: int, n_sum: int, n_min: int, n_max: int
                        ) -> Callable:
    """The sharded partial-aggregate step for a fixed plan shape. Inputs are
    tensors or `RowShards`, row-sharded over `data`; the outputs (count
    [G], per-agg counts [n_all, G], sums, mins, maxs) are combined on the
    mesh's first device."""

    def step(group_ids, mask, sum_values, min_values, max_values, valid):
        cols = [_shards(mesh, x) for x in (group_ids, mask, sum_values, min_values, max_values,
                                           valid)]
        n_all = cols[5][0].shape[0]
        partials = [
            _partial(*kernels.fused_groupby_block(*(c[p] for c in cols), num_groups, n_sum,
                                                  n_min, n_max))
            for p in mesh.column(0)
        ]
        out = combine(partials, _block_desc(1 + n_all + n_sum, n_min, n_max), mesh.devices[0])
        return _split(out, n_all, n_sum, n_min)

    return step


def distributed_groupby_2d(mesh: Mesh, groups_per_shard: int, n_sum: int, n_min: int,
                           n_max: int) -> Callable:
    """2D variant: rows shard over `data`, the group space over `groups`
    (each groups column owns `groups_per_shard` buckets). Rows outside a
    column's window are masked, not routed, and only the data axis combines;
    the outputs are the windows side by side on the mesh's first device."""

    def step(group_ids, mask, sum_values, min_values, max_values, valid):
        cols = [_shards(mesh, x) for x in (group_ids, mask, sum_values, min_values, max_values,
                                           valid)]
        n_all = cols[5][0].shape[0]
        desc = _block_desc(1 + n_all + n_sum, n_min, n_max)
        windows = []
        for g in range(mesh.n_groups):
            lo = g * groups_per_shard
            partials = []
            for p in mesh.column(g):
                ids, m, sv, mnv, mxv, vv = (c[p] for c in cols)
                local = ids - lo
                inside = (local >= 0) & (local < groups_per_shard)
                local = torch.clamp(local, 0, groups_per_shard - 1).to(torch.int32)
                partials.append(_partial(*kernels.fused_groupby_block(
                    local, m & inside, sv, mnv, mxv, vv, groups_per_shard, n_sum, n_min, n_max)))
            out = combine(partials, desc, mesh.devices[mesh.column(g)[0]])
            windows.append(out.to(mesh.devices[0]))
        return _split(torch.cat(windows, dim=1), n_all, n_sum, n_min)

    return step


def full_query_step(mesh: Mesh, num_groups: int) -> Callable:
    """One complete sharded step of the query engine: predicate mask ->
    dense group ids -> fused partial aggregate -> K10 combine; returns
    (count [G], sums [1, G]) on the mesh's first device. The arguments are
    JAX's: row-sharded columns, a replicated LUT, two ints."""

    def step(rel_time, status_codes, host_codes, lut, bin_units: int, num_host: int, values,
             valid):
        del status_codes  # in the signature, unused, as in the JAX step
        rt, hc, vals, ok = (_shards(mesh, x) for x in (rel_time, host_codes, values, valid))
        partials = []
        for p in mesh.column(0):
            dev = mesh.devices[p]
            mask = kernels.lut_mask(hc[p], lut.to(dev))
            bins = torch.div(rt[p], bin_units, rounding_mode="floor")
            ids = bins * num_host + torch.clamp(hc[p].to(torch.int32), max=num_host - 1)
            ids = torch.clamp(ids, 0, num_groups - 1).to(torch.int32)
            n = ids.shape[0]
            empty = torch.zeros((0, n), dtype=torch.float32, device=dev)
            count, _, sums, _, _ = kernels.fused_groupby_block(
                ids, mask, vals[p][None, :], empty, empty, ok[p][None, :], num_groups, 1, 0, 0)
            partials.append(torch.cat([count[None, :], sums], dim=0))
        out = combine(partials, _block_desc(2, 0, 0), mesh.devices[0])
        return out[0], out[1:]

    return step
