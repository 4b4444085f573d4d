"""Request scheduler for the continuous-batching engine.

Owns the waiting queue, the fixed slot set, and the block-pool bookkeeping:

* **admission** — a waiting request enters a free slot once its arrival time
  has passed and the pool can *reserve* its full block budget
  (``ceil((len(prompt) + max_new) / block_size)`` blocks for dense archs —
  reserved up front so a running request can never hit a mid-flight pool
  OOM; for uniform sliding-window archs the budget only covers the live
  window, since out-of-window blocks are recycled, so admission capacity
  scales with the window, not the sequence length);
* **lazy mapping** — physical blocks are drawn down from the reservation as
  positions are actually written (``ensure_mapped``), which is what lets
  speculative rollback (``KVBlockPool.truncate``) and window recycling
  return blocks without breaking the no-OOM guarantee;
* **eviction** — finished slots (EOS or ``max_new`` reached) free their
  mapped blocks and release the rest of their budget immediately, so the
  next waiting request backfills the slot while the remaining slots keep
  decoding;
* **policies** — ``fifo`` admits in arrival order; ``longest_prefill`` admits
  the longest waiting prompt first (front-loads heavy prefills so they
  overlap with many short decodes instead of serializing at the tail);
  ``cache_aware`` prefers the waiting request with the longest
  prefix-cache match (its tail budget is the smallest and its prefill the
  cheapest, so hits drain the queue fastest);
* **prefix sharing** — with a ``PrefixTree`` attached, admission matches
  each request's prompt against cached block-aligned prefixes: matched
  full blocks attach to the slot directly (one ``incref`` per attachment,
  no budget reserved, no prefill compute — the slot starts at
  ``pos = matched_len``), a partially matched boundary block becomes a
  copy-on-write fork (``Slot.cow``: the engine copies the source block's
  device contents into a private block drawn from the slot's own budget),
  and only the *unshared tail* reserves budget.  ``finish`` drops the
  slot's references — private blocks return to the free list, shared
  prefix blocks stay resident under the tree's own reference until LRU
  eviction (``PrefixTree.evict``) or admission pressure
  (``PrefixTree.evict_for``) lets them go.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.serving.kv_cache import KVBlockPool
from repro_torch.serving.prefix_tree import Match, PrefixTree

POLICIES = ("fifo", "longest_prefill", "cache_aware")


@dataclasses.dataclass
class Request:
    """One generation request.  ``tokens`` is filled by the engine."""
    rid: int
    prompt: List[int]
    max_new: int = 16
    temperature: float = 1.0
    greedy: bool = True
    eos_id: Optional[int] = None
    arrival: float = 0.0
    deadline_s: Optional[float] = None  # latency SLO: the request expires
                                        # once now > arrival + deadline_s
                                        # (waiting OR running) — see
                                        # ``Scheduler.expire``
    # -- engine-filled ------------------------------------------------------
    tokens: List[int] = dataclasses.field(default_factory=list)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None    # wall time of token #1
    finish_time: Optional[float] = None
    expired: bool = False   # evicted at its deadline (tokens may be partial)
    drafted: int = 0        # speculative: draft tokens proposed for this req
    accepted: int = 0       # speculative: draft tokens verified-accepted

    def past_deadline(self, now: float) -> bool:
        return (self.deadline_s is not None
                and now > self.arrival + self.deadline_s)

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new

    @property
    def ttft(self) -> float:
        """Time-to-first-token (seconds from arrival) — the latency
        prefix sharing actually moves: a cache hit skips the matched
        prefill outright."""
        if self.first_token_time is None:
            return float("nan")
        return self.first_token_time - self.arrival

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else float("nan")


@dataclasses.dataclass
class Slot:
    """Per-slot decode state.  ``pos`` is the next cache position to write
    (== committed tokens; speculative rollback rewinds it).  ``feed`` holds
    the tokens still to be fed through the persistent step: the prompt at
    admission (consumed in chunks — chunked prefill), then the single carry
    token once the slot is sampling; the first sampled token therefore
    comes out of the same engine step as every other one.  ``blocks`` maps
    logical block index -> physical block id (−1 = unmapped: not yet
    written, rolled back, or recycled out of the window); ``reserved`` is
    the slot's remaining block budget (unmapped blocks it may still draw
    from the pool)."""
    req: Request
    blocks: List[int] = dataclasses.field(default_factory=list)
    reserved: int = 0
    feed: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0
    generated: int = 0
    budget: int = 0         # blocks reserved at admission (private tail)
    num_shared: int = 0     # leading prefix-cache blocks (not budgeted;
                            # slot holds one pool reference each)
    cow: Optional[Tuple[int, int]] = None   # (src, dst) boundary-block
                            # copy the engine must run before the first
                            # step; src is pinned until then

    @property
    def in_prefill(self) -> bool:
        return self.generated == 0 and len(self.feed) > 1

    @property
    def history(self) -> List[int]:
        """Token history the drafter may match against: the prompt plus
        everything generated so far."""
        return self.req.prompt + self.req.tokens


class Scheduler:
    def __init__(self, num_slots: int, pool: KVBlockPool,
                 max_blocks_per_slot: int, policy: str = "fifo",
                 window: Optional[int] = None,
                 tree: Optional[PrefixTree] = None):
        """``window``: uniform sliding-window size in tokens (None/0 = full
        attention).  When set, per-request budgets cover only the live
        window span (+ one in-flight chunk, supplied per-request via
        ``chunk_tokens`` below) and ``recycle_window`` frees dead blocks.
        ``tree``: prefix cache; mutually exclusive with ``window`` (window
        recycling frees prompt blocks mid-request, which would yank them
        out from under later sharers — windowed archs bypass the cache)."""
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        if tree is not None and window:
            raise ValueError("prefix cache and sliding-window recycling "
                             "are mutually exclusive")
        self.pool = pool
        self.policy = policy
        self.max_blocks_per_slot = max_blocks_per_slot
        self.window = int(window) if window else 0
        self.tree = tree
        self.chunk_tokens = 1       # engine sets: max tokens fed per round
        self.waiting: List[Request] = []
        self.slots: List[Optional[Slot]] = [None] * num_slots
        self.peak_admitted = 0      # max simultaneously-occupied slots seen
        self.total_admitted = 0     # requests admitted over the run
        # per-run prefix-sharing counters (the tree's own counters are
        # cumulative across runs on a persistent engine)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_matched_tokens = 0
        self.prefix_prompt_tokens = 0
        self.prefix_shared_attached = 0     # full blocks attached shared
        self.prefix_forked = 0              # boundary blocks COW-forked

    # -- queries ------------------------------------------------------------
    @property
    def num_slots(self) -> int:
        return len(self.slots)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def budget_for(self, req: Request) -> int:
        """Block budget reserved at admission.  Dense: the full
        prompt+max_new footprint.  Windowed: the largest number of blocks
        simultaneously mapped — the window span plus the chunk being
        written, which can straddle two extra partial blocks."""
        need = self.pool.blocks_for(req.total_tokens)
        if self.window:
            live = self.pool.blocks_for(self.window + self.chunk_tokens) + 2
            need = min(need, live)
        return need

    # -- submission / admission --------------------------------------------
    def submit(self, req: Request) -> None:
        cap = self.max_blocks_per_slot * self.pool.block_size
        if req.total_tokens > cap:
            raise ValueError(
                f"request {req.rid}: {req.total_tokens} tokens exceeds the "
                f"per-slot capacity {cap}")
        need = self.budget_for(req)
        if need > self.pool.num_blocks:
            # would never admit -> the engine loop would spin forever
            raise ValueError(
                f"request {req.rid}: needs {need} blocks but the pool only "
                f"has {self.pool.num_blocks}")
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        self.waiting.append(req)

    def _ranked(self, now: float) -> List[int]:
        """Ready waiting-queue indices in admission-preference order."""
        ready = [i for i, r in enumerate(self.waiting) if r.arrival <= now]
        if self.policy == "longest_prefill":
            ready.sort(key=lambda i: (-len(self.waiting[i].prompt), i))
        elif self.policy == "cache_aware" and self.tree is not None:
            # longest cached prefix first: smallest tail budget, cheapest
            # prefill (dry-run match — no LRU perturbation)
            ready.sort(key=lambda i: (-self.tree.match(
                self.waiting[i].prompt, touch=False).matched_len, i))
        return ready

    def _try_admit(self, pick: int, free_slots: List[int],
                   now: float) -> Optional[int]:
        """Admit waiting[pick] if its unshared-tail budget fits (evicting
        LRU prefix-cache blocks under pressure); returns the slot index or
        None.  Matched prefix blocks attach shared (refcount bumped, no
        budget); a partially matched boundary block is COW-forked from the
        slot's own budget, its source pinned until the engine copies."""
        req = self.waiting[pick]
        m = self.tree.match(req.prompt) if self.tree is not None \
            else Match(blocks=[], matched_len=0)
        # pin every matched block BEFORE eviction runs: a childless matched
        # node (or the fork source) is otherwise fair game for the very
        # evict_for below, and would come back freed — or reallocated to
        # someone else.  The pins become the slot's own references on
        # success; on failure they are dropped.
        pinned = list(m.blocks)
        if m.fork_src is not None:
            pinned.append(m.fork_src)
        for b in pinned:
            self.pool.incref(b)
        need = self.budget_for(req) - len(m.blocks)
        if not self.pool.can_reserve(need):
            if self.tree is None \
                    or not self.tree.evict_for(self.pool, need) \
                    or not self.pool.can_reserve(need):
                if pinned:
                    self.pool.free(pinned)
                return None
        self.waiting.pop(pick)
        si = free_slots.pop(0)
        self.pool.reserve(need)
        slot = Slot(req=req, reserved=need, budget=need,
                    feed=list(req.prompt[m.matched_len:]),
                    pos=m.matched_len)
        slot.blocks = list(m.blocks)
        slot.num_shared = len(m.blocks)
        if m.fork_src is not None:
            # source stays pinned until the engine runs the device copy
            # (cow_executed); a later admission in this same admit() call
            # could otherwise evict it mid-flight
            dst = self.pool.alloc(1, reserved=True)[0]
            slot.reserved -= 1
            slot.blocks.append(dst)
            slot.cow = (m.fork_src, dst)
            self.prefix_forked += 1
        if self.tree is not None:
            self.prefix_hits += m.hit
            self.prefix_misses += not m.hit
            self.prefix_matched_tokens += m.matched_len
            self.prefix_prompt_tokens += len(req.prompt)
            self.prefix_shared_attached += len(m.blocks)
            self.tree.hits += m.hit
            self.tree.misses += not m.hit
            self.tree.matched_tokens += m.matched_len
        slot.req.admit_time = now if now != float("inf") else 0.0
        self.slots[si] = slot
        return si

    def admit(self, now: float = float("inf")) -> List[int]:
        """Admit as many ready requests as slots + block budget allow;
        returns the newly filled slot indices.  Admission only reserves —
        physical blocks are mapped lazily by ``ensure_mapped`` (matched
        prefix blocks attach immediately; see ``_try_admit``).  ``fifo``
        keeps head-of-line semantics: the oldest ready request blocks the
        queue until its budget fits.  The other policies scan the ready
        queue in preference order, so one over-budget request parked at
        the front cannot starve smaller ones that would fit now."""
        newly: List[int] = []
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        while free_slots and self.waiting:
            cands = self._ranked(now)
            if self.policy == "fifo":
                cands = cands[:1]           # documented head-of-line
            admitted = None
            for pick in cands:
                admitted = self._try_admit(pick, free_slots, now)
                if admitted is not None:
                    break
            if admitted is None:
                break
            newly.append(admitted)
        if newly:
            self.total_admitted += len(newly)
            self.peak_admitted = max(
                self.peak_admitted,
                sum(s is not None for s in self.slots))
        return newly

    def capacity_report(self) -> dict:
        """Bytes-denominated capacity snapshot: how much device memory the
        pool costs, what one admitted request's budget costs, and the
        admission high-water mark.  ``bytes_per_block`` = 0 when the pool
        was built without byte metadata."""
        bpb = self.pool.bytes_per_block
        out = {
            "num_blocks": self.pool.num_blocks,
            "block_size": self.pool.block_size,
            "bytes_per_block": bpb,
            "pool_bytes": self.pool.total_bytes,
            "peak_admitted": self.peak_admitted,
            "total_admitted": self.total_admitted,
        }
        if self.tree is not None:
            out["prefix"] = self.prefix_report()
        return out

    def prefix_report(self) -> dict:
        """Per-run prefix-sharing stats: hit rate over admitted requests,
        matched-token fraction, blocks attached shared / forked, and the
        pool bytes sharing saved (budget NOT reserved thanks to attached
        blocks).  ``tree`` holds the cumulative cross-run counters."""
        lookups = self.prefix_hits + self.prefix_misses
        return {
            "hits": self.prefix_hits,
            "misses": self.prefix_misses,
            "hit_rate": self.prefix_hits / lookups if lookups else 0.0,
            "matched_tokens": self.prefix_matched_tokens,
            "prompt_tokens": self.prefix_prompt_tokens,
            "matched_frac": (self.prefix_matched_tokens
                             / self.prefix_prompt_tokens
                             if self.prefix_prompt_tokens else 0.0),
            "shared_attached": self.prefix_shared_attached,
            "forked": self.prefix_forked,
            "bytes_saved": (self.prefix_shared_attached
                            * self.pool.bytes_per_block),
            "resident_blocks": self.tree.num_blocks
            if self.tree is not None else 0,
        }

    # -- prefix registration / copy-on-write --------------------------------
    def register_prefix(self, si: int) -> int:
        """Insert a slot's freshly prefilled prompt blocks into the prefix
        tree (the engine calls this the moment the prompt is fully
        written, so later arrivals in the same run can already share).
        The tree takes its own reference per new node; the slot keeps its
        own until ``finish``.  Returns blocks newly inserted."""
        if self.tree is None:
            return 0
        slot = self.slots[si]
        return self.tree.insert(slot.req.prompt, slot.blocks, self.pool)

    def cow_executed(self, si: int) -> None:
        """The engine finished the boundary-block device copy: unpin the
        source (admission pinned it so same-round eviction could not free
        it mid-copy)."""
        slot = self.slots[si]
        assert slot.cow is not None, f"no pending COW on slot {si}"
        self.pool.free([slot.cow[0]])
        slot.cow = None

    # -- lazy mapping / recycling -------------------------------------------
    def ensure_mapped(self, si: int, upto_pos: int) -> bool:
        """Map physical blocks for every logical block covering positions
        ``[0, upto_pos]`` that is still unmapped, drawing from the slot's
        reservation (capped by it: positions beyond the budgeted footprint
        stay unmapped and device writes there are dropped — never
        corrupted).  Returns True if the mapping changed."""
        slot = self.slots[si]
        need = min(self.pool.blocks_for(upto_pos + 1),
                   self.max_blocks_per_slot)
        changed = False
        if need > len(slot.blocks):
            slot.blocks.extend([-1] * (need - len(slot.blocks)))
        lo = 0
        if self.window:     # blocks below the window floor stay dead
            lo = max(0, (slot.pos - self.window + 1) // self.pool.block_size)
        for j in range(lo, need):
            if slot.blocks[j] < 0 and slot.reserved > 0:
                slot.blocks[j] = self.pool.alloc(1, reserved=True)[0]
                slot.reserved -= 1
                changed = True
        return changed

    def recycle_window(self, si: int) -> int:
        """Free mapped blocks that fell wholly out of the attention window
        (every key position <= pos − window can never be attended by a
        future query, since committed ``pos`` is monotone).  Budget returns
        to the slot, keeping its live-window mapping rights.  Returns the
        number of blocks recycled."""
        if not self.window:
            return 0
        slot = self.slots[si]
        bs = self.pool.block_size
        dead_upto = min(len(slot.blocks),
                        max(0, (slot.pos - self.window + 1) // bs))
        n = 0
        for j in range(dead_upto):
            if slot.blocks[j] >= 0:
                self.pool.free([slot.blocks[j]], rereserve=True)
                slot.blocks[j] = -1
                slot.reserved += 1
                n += 1
        return n

    # -- graceful degradation -----------------------------------------------
    def expire(self, now: float) -> List[Tuple[Optional[int], Request]]:
        """Evict every request past its ``deadline_s`` — graceful
        degradation under overload: a request that can no longer meet its
        SLO stops consuming capacity instead of starving those that can.

        Waiting requests simply leave the queue (they hold no resources).
        Running slots go through ``finish``, which returns every KV block,
        COW pin, budget reservation, and prefix-tree reference exactly as
        a natural completion would — the ledger sees no difference.
        Returns ``(slot_index | None, request)`` pairs (None = was still
        waiting) so the engine can clear the freed slots' block tables.
        """
        out: List[Tuple[Optional[int], Request]] = []
        keep: List[Request] = []
        for r in self.waiting:
            if r.past_deadline(now):
                r.expired = True
                r.finish_time = now
                out.append((None, r))
            else:
                keep.append(r)
        self.waiting = keep
        for si, slot in enumerate(self.slots):
            if slot is not None and slot.req.past_deadline(now):
                slot.req.expired = True
                out.append((si, self.finish(si, now)))
        return out

    def cancel(self, rid: int, now: float = 0.0) -> Optional[Request]:
        """Withdraw one request by id, waiting or running; same clean
        teardown as ``expire``.  Returns it, or None if unknown/finished.
        Callers driving an engine loop must clear the slot's block-table
        row when the returned request had been running."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                r.expired = True
                r.finish_time = now
                return self.waiting.pop(i)
        for si, slot in enumerate(self.slots):
            if slot is not None and slot.req.rid == rid:
                slot.req.expired = True
                return self.finish(si, now)
        return None

    # -- eviction -----------------------------------------------------------
    def finish(self, si: int, now: float = 0.0) -> Request:
        """Release the slot: every mapped block drops the slot's reference
        — private blocks return to the free list, shared prefix blocks
        stay resident under the tree's reference — and the leftover budget
        is released.  A never-executed COW pin (a request that finished
        before its first step, which the engine's flow does not produce)
        is dropped too, so the ledger stays leak-free regardless."""
        slot = self.slots[si]
        assert slot is not None, f"finish on empty slot {si}"
        if slot.cow is not None:
            self.pool.free([slot.cow[0]])
            slot.cow = None
        mapped = [b for b in slot.blocks if b >= 0]
        if mapped:
            self.pool.free(mapped)
        self.pool.release(slot.reserved)
        self.slots[si] = None
        if self.tree is not None and self.tree.max_blocks:
            # insert enforces the LRU bound too, but blocks attached to
            # live slots are unevictable then — re-check now that this
            # slot's references are gone
            self.tree.evict(self.pool, max(
                self.tree.num_blocks - self.tree.max_blocks, 0))
        slot.req.finish_time = now
        return slot.req
