"""The fold's front half (K3) as hand-written CUDA kernels: the packed
program, build, bind, launch, and plain versions.

Two kernels (source and design notes in `csrc/fold.cu`) do what the JAX
package traces as XLA programs in
`parseable_tpu/query/executor_tpu.py:2852 fold_one` (:2859-2907) with its
`PredicateCompiler` (:314) and `_kernel_stacks` (:838):

- `mask_ids(program, slots, n)` — K3a: a block's WHERE verdict (bool [N],
  with the time bounds and the padding mask) and its group ids (int32 [N]);
- `stack_operands(program, slots, mask, n_frows, n_brows)` — K3b: kernel
  A's row matrix, kernel B's value and validity rows and the liveness rows
  of K5-K7 (f32 [n_frows, N], bool [n_brows, N]).

Both interpret one PROGRAM, a small int32 array the host builds per block
(`Program`) and ships in the query's aux copy. Its layout:

- header, 8 words: MAGIC, instructions, operand rows, word offset of the
  data section, f32 rows, bool rows, slots, total words;
- instructions, 8 words each: [opcode, slot, a, b, c, d, e, 0]. Leaves push
  one (value, known) pair of SQL's three-valued logic:
  LUT (a: data byte offset of a bool LUT, b: its size, a power of two; the
  code is masked by size - 1), CMP_F32 / CMP_I32 (a: comparison, b: the f32
  bits or the int32 literal), CMP_F64 (a: comparison, b and c: the low and
  high words of the f64 literal; the values, f32 or f64, compared as f64),
  IN_F32 / NOT_IN_F32 and IN_F64 / NOT_IN_F64 (a: data byte offset of f32
  or f64 items, b: their count; IN_F64 reads f32 or f64 values as f64) —
  each (predicate & valid, valid) — IS_NULL / NOT_NULL (known 1) and
  CONST (a: value, b: known; a NULL literal is known 0); AND, OR and NOT
  combine pairs, NOT e is (known & ~value, known). KEY_DICT (a: remap offset, b: its size, c:
  capacity, d: stride) adds min(remap[code], cap - 1) * stride to the row's
  id; KEY_TIME (a: shift, b: bin ms, c: bin offset, d: capacity, e: stride)
  adds clamp(floor((ts + shift) / bin) + k_off, 0, cap - 1) * stride, in
  wrapping int32 arithmetic; KEY_CODE (a: capacity, b: stride) adds
  min(code, cap - 1) * stride of the slot's own codes, with no remap (the
  block-local fold of high-cardinality GROUP BYs); KEY_WINDOW (a: lo, b:
  n), after the keys, moves the row's id into one device's window of a
  groups-sharded mesh: id - lo, with the verdict ANDed with 0 <= id - lo < n
  and the id clamped into [0, n). The verdict is the value left on the
  stack;
- operand rows, 4 words each: [row op, slot, flags, output row]: MASK,
  LIVE (mask & valid, & not NaN with NAN_AWARE), MASKED (x where live, else
  0), VALUE (x); BOOL_OUT writes the bool matrix, else the f32 one. They
  are packed MASK first, then by slot, so that K3b loads each column once
  for all the rows that read it;
- data: LUTs, remaps and IN-lists, each 16-byte aligned.

A slot is one column of the block: its values (int8/int16/int32 codes or
times, f32, or the f64 copy of a column that is not exact in f32) and its
validity (bool, or None where the column has no
nulls). `slots` is the list of (values, valid) tensors, in the program's
slot order.

The plain versions interpret the same words with torch ops. A wrapper given
CPU tensors computes its plain version; given CUDA tensors it launches its
kernel or raises `KernelError`. `LAUNCHES` counts kernel launches per
wrapper. A program the kernels cannot hold (over MAX_STACK deep, more than
MAX_INSTR instructions, MAX_OPS operand rows or MAX_SLOTS columns) raises
`UnsupportedOnDevice` while it is built, on the host, before any launch.

Each kernel thread takes RUN rows, in chunks of 4 consecutive rows that a
warp reads and writes 128 rows at a time. Where N is a multiple of a
warp's 32 * RUN rows and every slot and output lies on a 16-byte boundary
(`vector_ok`; every block of the main path does) the kernels load and
store a chunk at a time (16 bytes of a 4-byte column); otherwise they take
their scalar variant, which gives the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from parseable_tpu_torch.ops.cuda_lib import CudaLibrary, KernelError, check, on_cuda, require

__all__ = [
    "KernelError", "LAUNCHES", "Program", "UnsupportedOnDevice", "mask_ids", "stack_operands",
]

MAGIC = 0x4B330001
HEADER_WORDS = 8
INSTR_WORDS = 8
OP_WORDS = 4
MAX_STACK = 32  # bits of the kernel's (value, known) stacks
MAX_INSTR = 128  # csrc kMaxInstr
MAX_OPS = 128  # csrc kMaxOps
MAX_SLOTS = 16  # csrc kMaxSlots

(LUT, CMP_F32, CMP_I32, IN_F32, NOT_IN_F32, IS_NULL, NOT_NULL, CONST,
 AND, OR, NOT, KEY_DICT, KEY_TIME, CMP_F64, IN_F64, NOT_IN_F64, KEY_CODE,
 KEY_WINDOW) = range(1, 19)
ROW_MASK, ROW_LIVE, ROW_MASKED, ROW_VALUE = range(1, 5)
NAN_AWARE, BOOL_OUT = 1, 2
CMP = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
DTYPES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float32: 3, torch.float64: 4}
_LEAVES = (LUT, CMP_F32, CMP_I32, IN_F32, NOT_IN_F32, IS_NULL, NOT_NULL, CONST,
           CMP_F64, IN_F64, NOT_IN_F64)
RUN = 16  # rows a kernel thread takes (csrc kRun)

# kernel launches per wrapper (plain integers; reset by whoever measures)
LAUNCHES = {"mask_ids": 0, "stack_operands": 0}


class UnsupportedOnDevice(Exception):
    """A query, block or program the device path cannot take."""


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    u64s, i32s = ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_int)
    lib.k3_mask_ids.argtypes = [p, u64s, u64s, i32s, i, ll, p, p, i, p]
    lib.k3_mask_ids.restype = i
    lib.k3_stack_operands.argtypes = [p, u64s, u64s, i32s, i, ll, p, p, p, i, p]
    lib.k3_stack_operands.restype = i


LIBRARY = CudaLibrary("fold.cu", _bind)


# ------------------------------------------------------------------ program


class Program:
    """Builds one block's packed program. `slot(values, valid)` registers a
    column by the keys of its tensors (None for no validity); the emitters
    append instructions and operand rows; `pack()` returns the int32 words.
    `slots` keeps the registered keys in slot order, for the caller to
    resolve into tensors."""

    def __init__(self) -> None:
        self.slots: list[tuple[str | None, str | None]] = []
        self._instr: list[list[int]] = []
        self._ops: list[list[int]] = []
        self._data = bytearray()
        self._depth = 0
        self.n_frows = 0
        self.n_brows = 0

    def slot(self, values: str | None, valid: str | None) -> int:
        key = (values, valid)
        if key not in self.slots:
            if len(self.slots) == MAX_SLOTS:
                raise UnsupportedOnDevice(f"program reads more than {MAX_SLOTS} columns")
            self.slots.append(key)
        return self.slots.index(key)

    def _data_at(self, arr: np.ndarray) -> int:
        at = len(self._data)
        self._data += np.ascontiguousarray(arr).tobytes()
        self._data += bytes(-len(self._data) % 16)
        return at

    def _emit(self, op: int, slot: int = 0, *args: int) -> None:
        if len(self._instr) == MAX_INSTR:
            raise UnsupportedOnDevice(f"program longer than {MAX_INSTR} instructions")
        if op in _LEAVES:
            self._depth += 1
            if self._depth > MAX_STACK:
                raise UnsupportedOnDevice(f"predicate deeper than the kernel's {MAX_STACK}-entry stack")
        elif op in (AND, OR):
            require(self._depth >= 2, "AND/OR needs two operands")
            self._depth -= 1
        elif op == NOT:
            require(self._depth >= 1, "NOT needs an operand")
        words = [op, slot, *args]
        self._instr.append(words + [0] * (INSTR_WORDS - len(words)))

    # leaves
    def lut(self, slot: int, table: np.ndarray) -> None:
        size = len(table)
        require(size > 0 and size & (size - 1) == 0, "a LUT's size must be a power of two")
        self._emit(LUT, slot, self._data_at(table.astype(np.bool_)), size)

    def cmp_f32(self, slot: int, op: str, value: float) -> None:
        self._emit(CMP_F32, slot, CMP[op], int(np.float32(value).view(np.int32)))

    def cmp_i32(self, slot: int, op: str, value: int) -> None:
        self._emit(CMP_I32, slot, CMP[op], int(value))

    def cmp_f64(self, slot: int, op: str, value: float) -> None:
        lo, hi = np.array([value], dtype=np.float64).view(np.int32)
        self._emit(CMP_F64, slot, CMP[op], int(lo), int(hi))

    def in_f32(self, slot: int, items: Sequence[float], negated: bool) -> None:
        arr = np.asarray(items, dtype=np.float32)
        self._emit(NOT_IN_F32 if negated else IN_F32, slot, self._data_at(arr), len(arr))

    def in_f64(self, slot: int, items: Sequence[float], negated: bool) -> None:
        arr = np.asarray(items, dtype=np.float64)
        self._emit(NOT_IN_F64 if negated else IN_F64, slot, self._data_at(arr), len(arr))

    def is_null(self, slot: int, negated: bool = False) -> None:
        self._emit(NOT_NULL if negated else IS_NULL, slot)

    def const(self, value: bool, known: bool = True) -> None:
        """A literal verdict; known=False is SQL's NULL (a comparison with a
        NULL literal), which drops the row and stays NULL under NOT."""
        self._emit(CONST, 0, int(bool(value) and known), int(bool(known)))

    # connectives
    def and_(self) -> None:
        self._emit(AND)

    def or_(self) -> None:
        self._emit(OR)

    def not_(self) -> None:
        self._emit(NOT)

    # group keys
    def key_dict(self, slot: int, remap: np.ndarray, cap: int, stride: int) -> None:
        size = len(remap)
        require(size > 0 and size & (size - 1) == 0, "a remap's size must be a power of two")
        self._emit(KEY_DICT, slot, self._data_at(remap.astype(np.int32)), size, cap, stride)

    def key_time(self, slot: int, shift: int, bin_ms: int, k_off: int, cap: int, stride: int) -> None:
        self._emit(KEY_TIME, slot, shift, bin_ms, k_off, cap, stride)

    def key_code(self, slot: int, cap: int, stride: int) -> None:
        self._emit(KEY_CODE, slot, cap, stride)

    def key_window(self, lo: int, n: int) -> None:
        """After the keys: the ids' window [lo, lo + n) of a groups-sharded
        mesh (`window_at` re-points a packed program at another window)."""
        require(self._depth == 1, "a window follows the verdict")
        self._emit(KEY_WINDOW, 0, lo, n)

    # operand rows (K3b)
    def row(self, op: int, slot: int = 0, *, nan_aware: bool = False, bool_out: bool = False) -> int:
        """Append an operand row; returns its index in its matrix."""
        if len(self._ops) == MAX_OPS:
            raise UnsupportedOnDevice(f"more than {MAX_OPS} operand rows")
        require(not (bool_out and op in (ROW_MASKED, ROW_VALUE)), "value rows are f32")
        at = self.n_brows if bool_out else self.n_frows
        flags = (NAN_AWARE if nan_aware else 0) | (BOOL_OUT if bool_out else 0)
        self._ops.append([op, slot, flags, at])
        if bool_out:
            self.n_brows += 1
        else:
            self.n_frows += 1
        return at

    def pack(self) -> np.ndarray:
        """The program's int32 words (one verdict must be on the stack)."""
        require(self._depth == 1, f"a program leaves one verdict, not {self._depth}")
        ops = sorted(self._ops, key=lambda o: (o[0] != ROW_MASK, o[1]))
        body = [w for ins in self._instr for w in ins] + [w for op in ops for w in op]
        data_off = HEADER_WORDS + len(body)
        data_off += -data_off % 4
        words = np.zeros(data_off + len(self._data) // 4, dtype=np.int32)
        words[:HEADER_WORDS] = [
            MAGIC, len(self._instr), len(self._ops), data_off, self.n_frows, self.n_brows,
            len(self.slots), len(words),
        ]
        words[HEADER_WORDS : HEADER_WORDS + len(body)] = body
        words[data_off:] = np.frombuffer(bytes(self._data), dtype=np.int32)
        return words


def window_at(words: np.ndarray, lo: int) -> np.ndarray:
    """A copy of packed program `words` whose KEY_WINDOW starts at `lo`."""
    out = words.copy()
    for k in range(int(words[1])):
        at = HEADER_WORDS + k * INSTR_WORDS
        if out[at] == KEY_WINDOW:
            out[at + 2] = lo
            return out
    raise KernelError("the program has no KEY_WINDOW")


# ------------------------------------------------------------ plain versions


def decode(program: torch.Tensor) -> tuple[list[list[int]], list[list[int]], int, torch.Tensor]:
    """(instructions, operand rows, data byte offset, the words) of a
    program on the CPU."""
    words = program.tolist()
    require(len(words) >= HEADER_WORDS and words[0] == MAGIC and words[7] == len(words),
            "not a packed K3 program")
    n_instr, n_ops, data_off = words[1], words[2], words[3]
    ins = [words[HEADER_WORDS + k * INSTR_WORDS : HEADER_WORDS + (k + 1) * INSTR_WORDS]
           for k in range(n_instr)]
    base = HEADER_WORDS + n_instr * INSTR_WORDS
    ops = [words[base + k * OP_WORDS : base + (k + 1) * OP_WORDS] for k in range(n_ops)]
    return ins, ops, 4 * data_off, program


def _data(program: torch.Tensor, at: int, count: int, dtype: torch.dtype) -> torch.Tensor:
    item = torch.empty((), dtype=dtype).element_size()
    return program.view(torch.uint8)[at : at + count * item].view(dtype)


def _compare(x: torch.Tensor, t, op: int) -> torch.Tensor:
    return (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)[op](x, t)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its int32 two's-complement wrap, as int64."""
    return (x + 2**31) % 2**32 - 2**31


def mask_ids_plain(
    program: torch.Tensor, slots: Sequence[tuple], n: int, with_ids: bool = True
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K3a in torch ops: the same program, interpreted over the whole block
    (on the program's device)."""
    ins, _, data_at, words = decode(program)
    dev = program.device
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    ids = torch.zeros(n, dtype=torch.int64, device=dev)
    stack: list[tuple[torch.Tensor, torch.Tensor]] = []

    def valid(slot: int) -> torch.Tensor:
        v = slots[slot][1]
        return ones if v is None else v

    for op, slot, a, b, c, d, e, _ in ins:
        if op == LUT:
            table = _data(words, data_at + a, b, torch.bool)
            code = slots[slot][0].to(torch.int64) & (b - 1)
            stack.append((table[code] & valid(slot), valid(slot)))
        elif op in (CMP_F32, CMP_I32):
            t = float(np.int32(b).view(np.float32)) if op == CMP_F32 else b
            stack.append((_compare(slots[slot][0], t, a) & valid(slot), valid(slot)))
        elif op == CMP_F64:
            t = float(np.array([b, c], dtype=np.int32).view(np.float64)[0])
            x = slots[slot][0].to(torch.float64)
            stack.append((_compare(x, t, a) & valid(slot), valid(slot)))
        elif op in (IN_F32, NOT_IN_F32, IN_F64, NOT_IN_F64):
            wide = op in (IN_F64, NOT_IN_F64)
            items = _data(words, data_at + a, b, torch.float64 if wide else torch.float32)
            x = slots[slot][0].to(torch.float64) if wide else slots[slot][0]
            hit = (x[:, None] == items[None, :]).any(dim=1)
            if op in (NOT_IN_F32, NOT_IN_F64):
                hit = ~hit
            stack.append((hit & valid(slot), valid(slot)))
        elif op == IS_NULL:
            stack.append((~valid(slot), ones))
        elif op == NOT_NULL:
            stack.append((valid(slot), ones))
        elif op == CONST:
            stack.append((torch.full((n,), bool(a), device=dev), torch.full((n,), bool(b), device=dev)))
        elif op in (AND, OR):
            (bv, bk), (av, ak) = stack.pop(), stack.pop()
            if op == AND:
                stack.append((av & bv, (ak & bk) | (ak & ~av) | (bk & ~bv)))
            else:
                stack.append((av | bv, (ak & bk) | av | bv))
        elif op == NOT:
            av, ak = stack.pop()
            stack.append((ak & ~av, ak))
        elif op == KEY_DICT:
            remap = _data(words, data_at + a, b, torch.int32).to(torch.int64)
            code = remap[slots[slot][0].to(torch.int64) & (b - 1)]
            ids += torch.clamp(code, max=c - 1) * d
        elif op == KEY_CODE:
            ids += torch.clamp(slots[slot][0].to(torch.int64), max=a - 1) * b
        elif op == KEY_TIME:
            x = _wrap32(slots[slot][0].to(torch.int64) + a)
            binned = _wrap32(torch.div(x, b, rounding_mode="floor") + c)
            ids += torch.clamp(binned, 0, d - 1) * e
        elif op == KEY_WINDOW:
            if not with_ids:
                continue
            local = _wrap32(_wrap32(ids) - a)
            inside = (local >= 0) & (local < b)
            v, k = stack.pop()
            stack.append((v & inside, k | ~inside))
            ids = torch.clamp(local, 0, b - 1)
        else:
            raise KernelError(f"unknown K3 opcode {op}")
    mask = stack[-1][0].clone()
    return mask, (_wrap32(ids).to(torch.int32) if with_ids else None)


def stack_operands_plain(
    program: torch.Tensor, slots: Sequence[tuple], mask: torch.Tensor, n_frows: int, n_brows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3b in torch ops: each operand row of the program, from the block's
    columns and the mask."""
    _, ops, _, _ = decode(program)
    n = mask.shape[0]
    frows = torch.empty((n_frows, n), dtype=torch.float32, device=mask.device)
    brows = torch.empty((n_brows, n), dtype=torch.bool, device=mask.device)
    for op, slot, flags, at in ops:
        x = None
        live = mask
        if op != ROW_MASK:
            values, valid = slots[slot]
            if valid is not None:
                live = live & valid
            if op != ROW_LIVE or flags & NAN_AWARE:
                x = values
            if flags & NAN_AWARE:
                live = live & ~torch.isnan(x)
        if flags & BOOL_OUT:
            brows[at] = live
        elif op == ROW_MASKED:
            frows[at] = torch.where(live, x, 0.0)
        elif op == ROW_VALUE:
            frows[at] = x
        else:
            frows[at] = live.to(torch.float32)
    return frows, brows


# ------------------------------------------------------------------ wrappers


def _check_slots(slots: Sequence[tuple], n: int) -> list[torch.Tensor]:
    require(len(slots) <= MAX_SLOTS, f"more than {MAX_SLOTS} slots")
    tensors = []
    for values, valid in slots:
        if values is not None:
            require(values.dtype in DTYPES and values.dim() == 1 and values.shape[0] == n,
                    "slot values must be int8/int16/int32/f32/f64 [N]")
            tensors.append(values)
        if valid is not None:
            require(valid.dtype == torch.bool and tuple(valid.shape) == (n,), "slot validity must be bool [N]")
            tensors.append(valid)
    return tensors


def _slot_table(slots: Sequence[tuple]):
    k = max(len(slots), 1)
    values = (ctypes.c_ulonglong * k)()
    valid = (ctypes.c_ulonglong * k)()
    dtypes = (ctypes.c_int * k)()
    for i, (v, m) in enumerate(slots):
        values[i] = 0 if v is None else v.data_ptr()
        valid[i] = 0 if m is None else m.data_ptr()
        dtypes[i] = DTYPES[v.dtype] if v is not None else DTYPES[torch.float32]
    return values, valid, dtypes


def _check_program(program: torch.Tensor) -> None:
    require(program.dtype == torch.int32 and program.dim() == 1 and program.numel() >= HEADER_WORDS,
            "program must be int32 [words]")


def vector_ok(n: int, tensors: Sequence[torch.Tensor]) -> bool:
    """May the kernels take their vector variant: N a multiple of a warp's
    32 * RUN rows and every tensor they read or write on a 16-byte
    boundary?"""
    return n % (32 * RUN) == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def mask_ids(
    program: torch.Tensor, slots: Sequence[tuple], n: int, *, with_ids: bool = True
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """K3a: (mask bool [N], group ids int32 [N], or None without `with_ids`)
    of one block, from its packed program and its column slots."""
    _check_program(program)
    tensors = _check_slots(slots, n)
    if not on_cuda(program, *tensors):
        return mask_ids_plain(program, slots, n, with_ids)
    require(all(t.is_contiguous() for t in (program, *tensors)), "inputs must be contiguous")
    mask = torch.empty(n, dtype=torch.bool, device=program.device)
    ids = torch.empty(n, dtype=torch.int32, device=program.device) if with_ids else None
    if n == 0:
        return mask, ids
    values, valid, dtypes = _slot_table(slots)
    vec = vector_ok(n, [*tensors, mask, *([ids] if ids is not None else [])])
    lib = LIBRARY.load()
    with torch.cuda.device(program.device):
        err = lib.k3_mask_ids(
            program.data_ptr(), values, valid, dtypes, len(slots), n, mask.data_ptr(),
            ids.data_ptr() if ids is not None else None, int(vec),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "mask_ids")
    LAUNCHES["mask_ids"] += 1
    return mask, ids


def stack_operands(
    program: torch.Tensor, slots: Sequence[tuple], mask: torch.Tensor, n_frows: int, n_brows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3b: (f32 [n_frows, N], bool [n_brows, N]) operand rows of one block,
    from its packed program, its column slots and its mask."""
    _check_program(program)
    require(mask.dtype == torch.bool and mask.dim() == 1, "mask must be bool [N]")
    n = mask.shape[0]
    tensors = _check_slots(slots, n)
    if not on_cuda(program, mask, *tensors):
        return stack_operands_plain(program, slots, mask, n_frows, n_brows)
    require(all(t.is_contiguous() for t in (program, mask, *tensors)), "inputs must be contiguous")
    frows = torch.empty((n_frows, n), dtype=torch.float32, device=mask.device)
    brows = torch.empty((n_brows, n), dtype=torch.bool, device=mask.device)
    if n == 0 or n_frows + n_brows == 0:
        return frows, brows
    values, valid, dtypes = _slot_table(slots)
    vec = vector_ok(n, [*tensors, mask, frows, brows])
    lib = LIBRARY.load()
    with torch.cuda.device(mask.device):
        err = lib.k3_stack_operands(
            program.data_ptr(), values, valid, dtypes, len(slots), n, mask.data_ptr(),
            frows.data_ptr(), brows.data_ptr(), int(vec), torch.cuda.current_stream().cuda_stream,
        )
    check(err, "stack_operands")
    LAUNCHES["stack_operands"] += 1
    return frows, brows
