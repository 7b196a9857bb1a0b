"""Device-resident hot set: encoded column blocks kept in the card's memory.

Counterpart of `parseable_tpu/ops/hotset.py` (`DeviceHotSet`, :107). Once a
Parquet file's columns have been encoded and copied to the card, later
queries over the same data run with no host encode and no host -> device
copy of the block: only the query's small LUTs and remaps cross.

Entries are keyed by the scan's source id (`path|size|rows`) plus the
column-set signature (`query/stubs.py` `hot_key`; no mesh in it, as in
the JAX package). `HotEntry.dev` holds the block's torch tensors (on the
CPU when the executor runs with `device="cpu"`), `meta` the EncodedBatch
with its host arrays stripped (dictionaries, vmin/vmax, flags and the time
origin stay). A block row-sharded over a mesh of several devices holds, in
`shards`, per mesh position its row shard's tensors on that position's
device, and its `placement` names the mesh; `nbytes` is the sum of its
copies. The executor takes an entry whose layout its mesh does not use as
a miss, and replaces it.

Eviction (policy "cost", the process-wide set's) is cost-aware. Each entry
carries a GDSF-style score

    score = clock + frequency * ship_cost(nbytes) / nbytes

("seconds of re-ship saved per resident byte", ship_cost from the measured
link profile, ops/link.py), so a cheap-to-refetch block is evicted before
an expensive one of equal heat. The set is segmented SLRU-style:

- a first touch lands in a *probationary* segment; a re-touch promotes to
  *protected*, capped at 80% of the budget (the weakest protected entry is
  demoted when a hotter one needs the room) — so probation always has
  churn space;
- eviction drains probation first, lowest score, ties broken NEWEST-first:
  a sequential over-budget scan churns one slot instead of rolling the
  whole segment (LRU's cyclic worst case);
- when probation is empty, admission control applies: a first-touch
  candidate must BEAT the weakest protected score to displace it, so a
  one-shot full scan cannot flush a dashboard working set;
- evicted/rejected keys leave a bounded *ghost* frequency behind: a block
  that keeps coming back re-enters with its earned heat.

Policy "lru" (`DeviceHotSet(policy="lru")`) keeps a plain byte-budgeted
LRU.

Entries larger than the whole budget are rejected — counted and logged
once per key, never silently dropped. The budget is P_TPU_HOT_BYTES
(default 8 GiB of device memory); `get_hotset()` re-roots the singleton
when P_TPU_HOT_BYTES changes. The JAX package's
Prometheus counters are plain counters here, read through
`stats_snapshot` (the session's `stats.stages.hotset`).
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

logger = logging.getLogger(__name__)

_POLICIES = ("cost", "lru")
# protected segment cap as a fraction of the budget: probation always keeps
# at least the rest, so churn can never be starved out by promotions
_PROTECTED_FRAC = 0.8
# remembered frequencies for evicted/rejected keys (bounded FIFO)
_GHOST_CAP = 4096


@dataclass
class HotEntry:
    dev: dict[str, Any]  # name -> torch tensor (values; validity where needed)
    meta: Any  # EncodedBatch with its host arrays stripped
    nbytes: int
    # CUDA event recorded after the copy when the block was shipped on a
    # side stream (the prefetcher): a consumer's stream waits on it before
    # any kernel reads the block; for a sharded block, (device, event) per
    # device
    ready: Any = None
    # a block row-sharded over a mesh of several devices: per mesh position
    # its shard's tensors (`dev` is then empty), and the mesh's placement
    shards: list[dict[str, Any]] | None = None
    placement: tuple = ()

    def tensors(self) -> list:
        """Every tensor of the entry, each once."""
        seen: dict[int, Any] = {id(t): t for t in self.dev.values()}
        for shard in self.shards or ():
            seen.update((id(t), t) for t in shard.values())
        return list(seen.values())


class _Slot:
    """Per-entry policy state (cost mode): GDSF score + segment."""

    __slots__ = ("entry", "freq", "pri", "probation", "seq")

    def __init__(self, entry: HotEntry):
        self.entry = entry
        self.freq = 1
        self.pri = 0.0
        self.probation = True
        self.seq = 0


def _default_ship_cost(nbytes: int) -> float:
    from parseable_tpu_torch.ops.link import get_link

    # seconds to re-ship this block, from the measured link profile — the
    # per-byte normalization happens in _priority
    return get_link().ship_cost_per_byte(nbytes) * max(1, nbytes)


class DeviceHotSet:
    """Byte-budgeted cache of encoded device blocks.

    Policy "cost": frequency x recency x re-ship-cost scoring with a
    probationary segment, admission control, and ghost frequencies (see
    module docstring). Policy "lru": plain LRU.
    """

    def __init__(
        self,
        budget_bytes: int | None = None,
        policy: str = "cost",
        ship_cost: Callable[[int], float] | None = None,
    ):
        from parseable_tpu_torch.config import env_int

        self.budget = budget_bytes or env_int("P_TPU_HOT_BYTES", 8 << 30)
        if policy not in _POLICIES:
            raise ValueError(f"hot-set policy {policy!r} is not one of {_POLICIES}")
        self.policy = policy
        # ship-cost estimator: measured link profile unless injected (tests)
        self._ship_cost = ship_cost or _default_ship_cost
        self._entries: OrderedDict[tuple, _Slot] = OrderedDict()  # guarded-by: self._lock
        self._bytes = 0  # guarded-by: self._lock
        self._protected_bytes = 0  # guarded-by: self._lock
        self._clock = 0.0  # guarded-by: self._lock - GDSF aging term
        self._seq = 0  # guarded-by: self._lock - insertion order
        self._ghost: OrderedDict[tuple, int] = OrderedDict()  # guarded-by: self._lock
        self._oversize_logged: set = set()  # guarded-by: self._lock
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.rejected_oversize = 0
        self.rejected_admission = 0  # first-touch puts that lost to protected heat

    # ------------------------------------------------------------------ score

    def _priority(self, slot: _Slot, clock: float) -> float:
        """clock + freq * ship_cost/byte: higher = more worth keeping."""
        nb = max(1, slot.entry.nbytes)
        try:
            cost = self._ship_cost(nb)
        except Exception:  # noqa: BLE001 - the estimator must never break the cache
            logger.debug("ship-cost estimate failed", exc_info=True)
            cost = nb / 8e9
        return clock + slot.freq * (cost / nb)

    # ------------------------------------------------------------------- get

    def get(self, key: tuple, touch: bool = True) -> HotEntry | None:
        """Fetch an entry. `touch=False` serves it WITHOUT counting reuse —
        the prefetcher's consumer uses this so a background ship + its one
        planned consumption can't masquerade as proven reuse."""
        with self._lock:
            slot = self._entries.get(key)
            if slot is None:
                self.misses += 1
                return None
            self.hits += 1
            entry = slot.entry
        if touch:
            self.touch(key)
        return entry

    def touch(self, key: tuple) -> None:
        """Apply the reuse accounting of a hit: bump recency + frequency,
        and promote a probationary entry with proven reuse into protected.

        Separate from `get`: the prefetch consumer fetches with
        `touch=False` and decides afterwards, atomically under the
        prefetcher's condition (`consumed()`), whether the hit was proven
        reuse. An entry evicted between a get and its touch is a no-op."""
        with self._lock:
            slot = self._entries.get(key)
            if slot is None:
                return
            self._entries.move_to_end(key)
            slot.freq += 1
            slot.pri = self._priority(slot, self._clock)
            if slot.probation and self.policy != "lru":
                # re-touch: proven reuse -> promote into protected, capped
                # at _PROTECTED_FRAC of the budget. Over the cap, the
                # weakest protected entry is demoted iff this one is hotter
                nb = slot.entry.nbytes
                cap = int(self.budget * _PROTECTED_FRAC)
                if self._protected_bytes + nb <= cap:
                    slot.probation = False
                    self._protected_bytes += nb
                else:
                    prot = [s for s in self._entries.values() if not s.probation]
                    if prot:
                        weakest = min(prot, key=lambda s: s.pri)
                        if weakest.pri < slot.pri:
                            weakest.probation = True
                            self._protected_bytes -= weakest.entry.nbytes
                            slot.probation = False
                            self._protected_bytes += nb

    # ------------------------------------------------------------------- put

    def _remember(self, key: tuple, freq: int) -> None:  # caller holds self._lock
        self._ghost[key] = freq
        self._ghost.move_to_end(key)
        if len(self._ghost) > _GHOST_CAP:
            self._ghost.popitem(last=False)

    def put(self, key: tuple, entry: HotEntry) -> None:
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.entry.nbytes
                if not old.probation:
                    self._protected_bytes -= old.entry.nbytes
            if entry.nbytes > self.budget:
                # would never fit; don't evict others for it — but COUNT it:
                # a silently un-cacheable block re-ships on every query
                self.rejected_oversize += 1
                if key not in self._oversize_logged:
                    if len(self._oversize_logged) < 1024:
                        self._oversize_logged.add(key)
                    logger.warning(
                        "hot-set entry %r (%d bytes) exceeds the whole budget "
                        "(%d); it will re-ship on every query — raise "
                        "P_TPU_HOT_BYTES or shrink P_TPU_BLOCK_ROWS",
                        key[0] if key else key,
                        entry.nbytes,
                        self.budget,
                    )
                return
            slot = _Slot(entry)
            # ghost frequency: a key that keeps coming back re-enters with
            # the heat it earned before eviction/rejection
            slot.freq = self._ghost.pop(key, 0) + 1
            if old is not None:
                # replacement (e.g. a refreshed encoding): keep the key's
                # earned heat and segment instead of demoting it
                slot.freq = max(slot.freq, old.freq)
                slot.probation = old.probation
            slot.pri = self._priority(slot, self._clock)
            while self._bytes + entry.nbytes > self.budget and self._entries:
                # evict one entry under the active policy
                if self.policy == "lru":
                    vkey = next(iter(self._entries))
                    victim = self._entries.pop(vkey)
                else:
                    probation = [(k, s) for k, s in self._entries.items() if s.probation]
                    if probation:
                        # scan resistance: probation drains first, lowest
                        # score first; score ties break NEWEST-first, so a
                        # sequential over-budget scan churns a single slot.
                        # No clock inflation here: intra-probation churn
                        # must keep score ties exact
                        vkey, victim = min(probation, key=lambda kv: (kv[1].pri, -kv[1].seq))
                        self._entries.pop(vkey)
                    else:
                        # every resident has proven reuse. Admission
                        # control: a first-touch candidate must BEAT the
                        # weakest protected score to displace it; its ghost
                        # frequency still grows
                        vkey, victim = min(self._entries.items(), key=lambda kv: kv[1].pri)
                        if slot.probation and slot.pri <= victim.pri:
                            self.rejected_admission += 1
                            self._remember(key, slot.freq)
                            return
                        self._entries.pop(vkey)
                        self._protected_bytes -= victim.entry.nbytes
                        # aging: future scores start from the evicted
                        # protected score
                        if victim.pri > self._clock:
                            self._clock = victim.pri
                self._bytes -= victim.entry.nbytes
                self.evictions += 1
                self._remember(vkey, victim.freq)
            self._seq += 1
            slot.seq = self._seq
            self._entries[key] = slot
            self._bytes += entry.nbytes
            if not slot.probation:
                self._protected_bytes += entry.nbytes

    # ----------------------------------------------------------------- peeks

    def contains(self, key: tuple) -> bool:
        """Peek without touching recency/frequency or hit/miss counters."""
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._ghost.clear()
            self._bytes = 0
            self._protected_bytes = 0
            self._clock = 0.0

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats_snapshot(self) -> dict:
        """One consistent read of the cache's state (stats.stages.hotset)."""
        with self._lock:
            return {
                "policy": self.policy,
                "budget_bytes": self.budget,
                "resident_bytes": self._bytes,
                "protected_bytes": self._protected_bytes,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "rejected_oversize": self.rejected_oversize,
                "rejected_admission": self.rejected_admission,
            }


_GLOBAL_HOTSET: DeviceHotSet | None = None
_HOTSET_LOCK = threading.Lock()


def get_hotset() -> DeviceHotSet:
    """Process-wide hot set (cost policy); re-roots (drops the old
    instance, its tensors freed when the last query holding them ends) when
    P_TPU_HOT_BYTES changes, so tests and long-lived servers can resize the
    budget without stale singletons."""
    from parseable_tpu_torch.config import env_int

    global _GLOBAL_HOTSET
    budget = env_int("P_TPU_HOT_BYTES", 8 << 30)
    with _HOTSET_LOCK:
        hs = _GLOBAL_HOTSET
        if hs is None or hs.budget != budget:
            _GLOBAL_HOTSET = DeviceHotSet(budget_bytes=budget)
        return _GLOBAL_HOTSET
