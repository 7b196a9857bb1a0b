"""Partial-aggregate tables and their vectorized merge.

Counterpart of `parseable_tpu/query/partials.py` (:49-572), trimmed to the
two-phase aggregate both port engines run: each scanned block reduces to a
*partial table* — group keys as `__g{i}` columns plus `__cnt` (rows per
group) and per-spec `__pac{si}` (non-null input count), `__sum{si}`,
`__sumsq{si}`, `__min{si}`, `__max{si}` — and ONE pyarrow group_by merges
every partial at finalize. The CPU engine builds partials from per-block
group_bys (`partial_from_block`), the GPU engine from its dense and
block-local accumulators, so a 1M-group query costs one Arrow C++ hash
aggregation, never a per-group Python loop.

Fast path: the block phase dictionary-encodes each key once and groups on a
single combined int64 code. The merge unifies per-block dictionaries into
global codes (`index_in` over dictionaries: dictionary-sized work, never
row-count-sized) and groups on one int64 again. String keys stay
dictionary-typed in the interim table, so only the rows that survive LIMIT
decode. Anything the fast path cannot express (combined code overflow,
key types it cannot encode) takes the multi-column group_by.

The session's partial-result cache (`PartialResultCache`, JAX :61-179)
keeps merged interims keyed on (stream, manifest-set fingerprint, plan
fingerprint). `combine_partials` folds one node's partials into a single
partial table that stays mergeable: the distributed pushdown's wire shape
(`query/fanout.py`).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from parseable_tpu_torch.query import sql as S

# aggregate functions expressible in partial format: stddev/var carry
# (count, sum, sum-of-squares) columns; percentile/distinct need sketch or
# set state and take the classic HashAggregator path
PARTIALIZABLE_FUNCS = {
    "count_star", "count", "sum", "avg", "min", "max", "stddev", "var",
}

_MAX_COMBINED = 1 << 62  # combined-code capacity guard


def specs_partializable(specs) -> bool:
    return all(s.func in PARTIALIZABLE_FUNCS for s in specs)


class _FastPathUnavailable(Exception):
    pass


# --------------------------------------------------------------------------
# partial-aggregate result cache


class PartialResultCache:
    """LRU cache of *finalized partials* — the merged interim (__g/__agg)
    table an aggregate produces after consuming its whole scan — keyed on
    (stream, manifest-set fingerprint, plan fingerprint).

    A repeated `GROUP BY` over an unchanged snapshot then skips the scan:
    the session re-runs only HAVING, projection, ORDER BY and LIMIT over
    the cached interim. The manifest-set fingerprint covers every (path,
    size, rows) the scan would read, so any snapshot commit changes the
    key; `update_snapshot` also evicts the stream's entries eagerly so
    stale interims do not hold the byte budget. Arrow tables are
    immutable, so entries are shared without copies. Thread-safe."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max(1, max_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, pa.Table] = OrderedDict()  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self.hits = 0  # guarded-by: self._lock
        self.misses = 0  # guarded-by: self._lock

    def get(self, key: tuple) -> pa.Table | None:
        with self._lock:
            table = self._entries.get(key)
            if table is None:
                self.misses += 1
            else:
                self.hits += 1
                self._entries.move_to_end(key)
            return table

    def put(self, key: tuple, table: pa.Table) -> None:
        size = table.nbytes
        if size > self.max_bytes:
            return  # one oversized interim must not wipe the whole cache
        with self._lock:
            prev = self._entries.pop(key, None)
            if prev is not None:
                self._bytes -= prev.nbytes
            self._entries[key] = table
            self._bytes += size
            while self._bytes > self.max_bytes and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes

    def invalidate_stream(self, stream: str) -> int:
        """Evict every entry of `stream` (a snapshot commit)."""
        with self._lock:
            doomed = [k for k in self._entries if k[0] == stream]
            for k in doomed:
                self._bytes -= self._entries.pop(k).nbytes
        return len(doomed)


_RESULT_CACHE: PartialResultCache | None = None
_RESULT_CACHE_LOCK = threading.Lock()


def get_result_cache(options=None) -> PartialResultCache | None:
    """Process-wide result cache sized by P_QUERY_RESULT_CACHE_BYTES (0
    disables). Re-roots when the configured budget changes."""
    global _RESULT_CACHE
    budget = getattr(options, "query_result_cache_bytes", 64 * 1024 * 1024)
    if budget <= 0:
        return None
    with _RESULT_CACHE_LOCK:
        if _RESULT_CACHE is None or _RESULT_CACHE.max_bytes != budget:
            _RESULT_CACHE = PartialResultCache(budget)
        return _RESULT_CACHE


def invalidate_result_cache(stream: str) -> int:
    """Snapshot-commit hook (`core.update_snapshot`): drop the stream's
    cached interims the moment the manifest set they were built from is
    superseded."""
    with _RESULT_CACHE_LOCK:
        cache = _RESULT_CACHE
    return cache.invalidate_stream(stream) if cache is not None else 0


def manifest_fingerprint(files) -> str:
    """Content fingerprint of a scan's manifest set: (path, size, rows) of
    every file the pruned scan would read."""
    h = hashlib.blake2b(digest_size=16)
    for f in sorted(files, key=lambda f: f.file_path):
        h.update(f"{f.file_path}|{f.file_size}|{f.num_rows}\n".encode())
    return h.hexdigest()


def plan_fingerprint(lp, engine: str) -> str:
    """Fingerprint of what the interim depends on: the whole statement
    (WHERE, GROUP BY, aggregates), the effective time bounds, the columns
    read, and the engine (device partial sums are f32 per block: close to
    the CPU engine's f64, not equal)."""
    cols = sorted(lp.needed_columns) if lp.needed_columns is not None else ["*"]
    text = "\x1f".join(
        [
            S.format_statement(lp.select),
            str(lp.time_bounds.low),
            str(lp.time_bounds.high),
            ",".join(cols),
            engine,
        ]
    )
    return hashlib.blake2b(text.encode(), digest_size=16).hexdigest()


def _encode_key(arr: pa.ChunkedArray | pa.Array) -> tuple[np.ndarray, pa.Array]:
    """One key column -> (codes int64, dict); null rows code len(dict)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    try:
        denc = arr if pa.types.is_dictionary(arr.type) else pc.dictionary_encode(arr)
    except pa.ArrowNotImplementedError as e:
        raise _FastPathUnavailable(str(e)) from e
    if isinstance(denc, pa.ChunkedArray):
        denc = denc.combine_chunks()
    dictionary = denc.dictionary
    idx = denc.indices
    codes = pc.fill_null(idx, 0).to_numpy(zero_copy_only=False).astype(np.int64)
    if idx.null_count:
        codes = codes.copy()
        codes[~np.asarray(idx.is_valid())] = len(dictionary)
    if dictionary.null_count:
        # null VALUES inside a dictionary (device partials use a null slot)
        # collapse into the same null code as masked indices, or the merge
        # would keep two unmergeable null groups
        valid = np.asarray(dictionary.is_valid())
        clean = dictionary.drop_null()
        lut = np.concatenate(
            [np.where(valid, np.cumsum(valid, dtype=np.int64) - 1, len(clean)), [len(clean)]]
        )
        codes = lut[codes]
        dictionary = clean
    return codes, dictionary


def _combine_codes(codes_list: list[np.ndarray], sizes: list[int]) -> np.ndarray:
    """codes -> single int64, LAST key least-significant."""
    prod = 1
    for size in sizes:
        prod *= size
        if prod > _MAX_COMBINED:
            raise _FastPathUnavailable("combined group-code space exceeds int64")
    combined = codes_list[0]
    for codes, size in zip(codes_list[1:], sizes[1:]):
        combined = combined * size + codes
    return combined


def _split_codes(gcodes: np.ndarray, sizes: list[int]) -> list[np.ndarray]:
    n = len(sizes)
    cols: list[np.ndarray] = [None] * n  # type: ignore[list-item]
    rem = gcodes
    for i in range(n - 1, 0, -1):
        cols[i] = rem % sizes[i]
        rem = rem // sizes[i]
    cols[0] = rem
    return cols


def _group_codes_to_key_arrays(
    gcodes: np.ndarray, dicts: list[pa.Array], sizes: list[int]
) -> list[pa.Array]:
    """Combined group codes -> per-key arrays. String/binary keys come back
    dictionary-typed (no value materialization); other types decode via one
    take per key (group-count sized, not row-count sized)."""
    out: list[pa.Array] = []
    for code, d in zip(_split_codes(gcodes, sizes), dicts):
        if len(d) == 0:  # all-null key
            out.append(pa.nulls(len(code), d.type))
            continue
        null_slot = len(d)
        mask = code == null_slot
        idx = pa.array(np.where(mask, 0, code).astype(np.int32), mask=mask)
        dict_arr = pa.DictionaryArray.from_arrays(idx, d)
        if pa.types.is_string(d.type) or pa.types.is_large_string(d.type) or pa.types.is_binary(d.type):
            out.append(dict_arr)
        else:
            out.append(dict_arr.cast(d.type))
    return out


def decode_dictionary_columns(table: pa.Table) -> pa.Table:
    """Materialize dictionary-typed columns as plain values (for arrow
    kernels without dictionary support)."""
    cols = []
    changed = False
    for col in table.columns:
        if pa.types.is_dictionary(col.type):
            cols.append(col.cast(col.type.value_type))
            changed = True
        else:
            cols.append(col)
    if not changed:
        return table
    return pa.table(dict(zip(table.column_names, cols)))


def partial_fields(specs: list) -> list[tuple[str, int, str]]:
    """The partial schema's aggregate columns after `__cnt`, in order:
    (column, spec index, field), field one of "pac" (non-null inputs),
    "sum", "sumsq" (raw sum of squares), "min" and "max". Every builder of
    a partial table, and the merge, read the schema from here."""
    fields: list[tuple[str, int, str]] = []
    for si, spec in enumerate(specs):
        if spec.func == "count_star":
            continue
        fields.append((f"__pac{si}", si, "pac"))
        if spec.func in ("sum", "avg", "stddev", "var"):
            fields.append((f"__sum{si}", si, "sum"))
        if spec.func in ("stddev", "var"):
            fields.append((f"__sumsq{si}", si, "sumsq"))
        if spec.func in ("min", "max"):
            fields.append((f"__{spec.func}{si}", si, spec.func))
    return fields


# a field's block-phase input column prefix and pyarrow aggregate
_FIELD_SOURCE = {
    "pac": ("__a", "count"), "sum": ("__a", "sum"), "sumsq": ("__asq", "sum"),
    "min": ("__a", "min"), "max": ("__a", "max"),
}


def _agg_plan(specs: list) -> list[tuple]:
    aggs: list[tuple] = [([], "count_all")]
    for _, si, field in partial_fields(specs):
        prefix, op = _FIELD_SOURCE[field]
        aggs.append((f"{prefix}{si}", op))
    return aggs


def _partial_out(g: pa.Table, specs: list) -> dict[str, Any]:
    out: dict[str, Any] = {"__cnt": pc.cast(g.column("count_all"), pa.float64())}
    for name, si, field in partial_fields(specs):
        prefix, op = _FIELD_SOURCE[field]
        col = g.column(f"{prefix}{si}_{op}")
        out[name] = col if field in ("min", "max") else pc.cast(col, pa.float64())
    return out


def partial_from_block(table: pa.Table, group_exprs: list, specs: list) -> pa.Table | None:
    """CPU half: one block's partial aggregate via pyarrow group_by."""
    from parseable_tpu_torch.query.executor import _arr, evaluate

    if table.num_rows == 0:
        return None
    key_arrays = [_arr(evaluate(g, table), table) for g in group_exprs]
    agg_cols: dict[str, Any] = {}
    for si, spec in enumerate(specs):
        if spec.func != "count_star":
            agg_cols[f"__a{si}"] = _arr(evaluate(spec.arg, table), table)
        if spec.func in ("stddev", "var"):
            # float64 before squaring: int64 squares wrap silently
            fv = pc.cast(agg_cols[f"__a{si}"], pa.float64(), safe=False)
            agg_cols[f"__asq{si}"] = pc.multiply(fv, fv)

    try:
        codes_list, dicts, sizes = [], [], []
        for a in key_arrays:
            codes, d = _encode_key(a)
            codes_list.append(codes)
            dicts.append(d)
            sizes.append(len(d) + 1)  # +1: the null slot
        combined = _combine_codes(codes_list, sizes)
        tmp = pa.table({"__k": pa.array(combined), **agg_cols})
        g = tmp.group_by(["__k"], use_threads=False).aggregate(_agg_plan(specs))
        gcodes = g.column("__k").to_numpy(zero_copy_only=False)
        out: dict[str, Any] = {}
        for i, arr in enumerate(_group_codes_to_key_arrays(gcodes, dicts, sizes)):
            out[f"__g{i}"] = arr
        out.update(_partial_out(g, specs))
        return pa.table(out)
    except _FastPathUnavailable:
        pass

    # group on the key columns directly
    key_names = [f"__g{i}" for i in range(len(key_arrays))]
    cols = dict(zip(key_names, key_arrays))
    cols.update(agg_cols)
    tmp = pa.table(cols) if cols else pa.table({"__d": pa.nulls(table.num_rows, pa.int8())})
    g = tmp.group_by(key_names, use_threads=False).aggregate(_agg_plan(specs))
    out = {k: g.column(k) for k in key_names}
    out.update(_partial_out(g, specs))
    return pa.table(out)


def _global_codes(partials: list[pa.Table], key: str) -> tuple[list[np.ndarray], pa.Array]:
    """Unify one key column's per-partial dictionaries into global codes
    (null -> -1). index_in runs over dictionaries, never over group rows."""
    global_vals: pa.Array | None = None
    pending: list[tuple[np.ndarray, pa.Array]] = []
    for t in partials:
        codes, d = _encode_key(t.column(key))
        codes = np.where(codes == len(d), np.int64(-1), codes)
        pending.append((codes, d))
        if global_vals is None:
            global_vals = d
        else:
            if len(d) and d.type != global_vals.type:
                try:
                    if len(global_vals) == 0:
                        global_vals = global_vals.cast(d.type)
                    else:
                        d = d.cast(global_vals.type)
                        pending[-1] = (codes, d)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as e:
                    # incompatible-but-promotable key types (int64 block vs
                    # float64 block): the multi-column merge promotes them
                    # through concat_tables(permissive)
                    raise _FastPathUnavailable(str(e)) from e
            if len(d):
                lut = pc.index_in(d, global_vals)
                if lut.null_count:
                    new_vals = d.filter(pc.is_null(lut))
                    global_vals = pa.concat_arrays([global_vals, new_vals.cast(global_vals.type)])
    assert global_vals is not None
    per_partial: list[np.ndarray] = []
    for codes, d in pending:
        if len(d) == 0:
            per_partial.append(codes)
            continue
        lut = (
            pc.index_in(d.cast(global_vals.type), global_vals)
            .to_numpy(zero_copy_only=False)
            .astype(np.int64)
        )
        per_partial.append(np.where(codes < 0, np.int64(-1), lut[np.maximum(codes, 0)]))
    return per_partial, global_vals


def _merge_aggs(specs: list) -> list[tuple]:
    aggs: list[tuple] = [("__cnt", "sum")]
    for name, _, field in partial_fields(specs):
        aggs.append((name, field if field in ("min", "max") else "sum"))
    return aggs


def _merge_out(g: pa.Table, specs: list) -> dict[str, Any]:
    cols: dict[str, Any] = {}
    for si, spec in enumerate(specs):
        if spec.func == "count_star":
            cols[f"__agg{si}"] = pc.cast(g.column("__cnt_sum"), pa.int64(), safe=False)
            continue
        pacv = g.column(f"__pac{si}_sum")
        if spec.func == "count":
            cols[f"__agg{si}"] = pc.cast(pacv, pa.int64(), safe=False)
        elif spec.func in ("sum", "avg"):
            s = g.column(f"__sum{si}_sum")
            seen = pc.greater(pacv, 0)
            val = pc.divide(s, pacv) if spec.func == "avg" else s
            cols[f"__agg{si}"] = pc.if_else(seen, val, pa.scalar(None, pa.float64()))
        elif spec.func in ("stddev", "var"):
            # sample variance (n-1 denominator, DataFusion semantics)
            n = np.asarray(pc.cast(pacv, pa.float64()).to_numpy(zero_copy_only=False))
            s = np.asarray(
                pc.cast(pc.fill_null(g.column(f"__sum{si}_sum"), 0.0), pa.float64())
                .to_numpy(zero_copy_only=False)
            )
            sq = np.asarray(
                pc.cast(pc.fill_null(g.column(f"__sumsq{si}_sum"), 0.0), pa.float64())
                .to_numpy(zero_copy_only=False)
            )
            ok = n >= 2
            var = np.divide(
                sq - np.divide(s * s, n, out=np.zeros_like(s), where=ok),
                n - 1,
                out=np.zeros_like(s),
                where=ok,
            )
            var = np.maximum(var, 0.0)  # guard f.p. negatives
            val = np.sqrt(var) if spec.func == "stddev" else var
            cols[f"__agg{si}"] = pa.array(val, mask=~ok)
        elif spec.func == "min":
            cols[f"__agg{si}"] = g.column(f"__min{si}_min")
        elif spec.func == "max":
            cols[f"__agg{si}"] = g.column(f"__max{si}_max")
    return cols


def _combine_out(g: pa.Table, specs: list) -> dict[str, Any]:
    """Re-emit the merged group table in PARTIAL format (`__cnt`/`__pac`/
    `__sum`/`__sumsq`/`__min`/`__max`) instead of finalized `__agg` slots:
    a per-node reduction that stays mergeable. A finalized avg or stddev
    cannot be merged again across nodes (an avg of avgs weights nodes, not
    rows), so the pushdown ships this shape and the querier's
    `merge_partials` takes each peer's table as one more block."""
    cols: dict[str, Any] = {"__cnt": g.column("__cnt_sum")}
    for si, spec in enumerate(specs):
        if spec.func == "count_star":
            continue
        cols[f"__pac{si}"] = g.column(f"__pac{si}_sum")
        if spec.func in ("sum", "avg"):
            cols[f"__sum{si}"] = g.column(f"__sum{si}_sum")
        elif spec.func in ("stddev", "var"):
            cols[f"__sum{si}"] = g.column(f"__sum{si}_sum")
            cols[f"__sumsq{si}"] = g.column(f"__sumsq{si}_sum")
        elif spec.func == "min":
            cols[f"__min{si}"] = g.column(f"__min{si}_min")
        elif spec.func == "max":
            cols[f"__max{si}"] = g.column(f"__max{si}_max")
    return cols


def merge_partials(partials: list[pa.Table], specs: list, nkeys: int) -> pa.Table:
    """Final half: merge partial tables -> interim (__g/__agg) table for
    finalize_from_interim."""
    return _merge_partial_tables(partials, specs, nkeys, _merge_out)


def combine_partials(partials: list[pa.Table], specs: list, nkeys: int) -> pa.Table:
    """Node-local reduction for the distributed pushdown: merge this node's
    per-block partials into ONE partial-format table (the columns of
    `partial_from_block`) that the querier merges again. avg, stddev and
    var stay exact: the carried state is (count, sum[, sumsq])."""
    return _merge_partial_tables(partials, specs, nkeys, _combine_out)


def _merge_partial_tables(partials: list[pa.Table], specs: list, nkeys: int, out_fn) -> pa.Table:
    non_key = [c for t in partials for c in t.column_names if not c.startswith("__g")]
    non_key = list(dict.fromkeys(non_key))

    if nkeys:
        try:
            dicts: list[pa.Array] = []
            sizes: list[int] = []
            per_key_codes: list[list[np.ndarray]] = []
            for i in range(nkeys):
                codes_per_partial, gdict = _global_codes(partials, f"__g{i}")
                per_key_codes.append(codes_per_partial)
                dicts.append(gdict)
                sizes.append(len(gdict) + 1)
            prod = 1
            for s in sizes:
                prod *= s
                if prod > _MAX_COMBINED:
                    raise _FastPathUnavailable("combined group-code space exceeds int64")
            stripped = []
            for pi, t in enumerate(partials):
                codes_list = [
                    np.where(per_key_codes[ki][pi] < 0, np.int64(len(dicts[ki])), per_key_codes[ki][pi])
                    for ki in range(nkeys)
                ]
                combined = _combine_codes(codes_list, sizes)
                keep = {c: t.column(c) for c in non_key if c in t.column_names}
                keep["__k"] = pa.array(combined)
                stripped.append(pa.table(keep))
            t = pa.concat_tables(stripped, promote_options="permissive")
            g = t.group_by(["__k"], use_threads=False).aggregate(_merge_aggs(specs))
            gcodes = g.column("__k").to_numpy(zero_copy_only=False)
            cols: dict[str, Any] = {}
            for i, arr in enumerate(_group_codes_to_key_arrays(gcodes, dicts, sizes)):
                cols[f"__g{i}"] = arr
            cols.update(out_fn(g, specs))
            return pa.table(cols)
        except _FastPathUnavailable:
            pass

    # group on the key columns directly (decoded to plain values)
    t = pa.concat_tables(
        [decode_dictionary_columns(p) for p in partials], promote_options="permissive"
    )
    keys = [f"__g{i}" for i in range(nkeys)]
    g = t.group_by(keys, use_threads=False).aggregate(_merge_aggs(specs))
    cols = {f"__g{i}": g.column(f"__g{i}") for i in range(nkeys)}
    cols.update(out_fn(g, specs))
    return pa.table(cols)
