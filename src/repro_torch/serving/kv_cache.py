"""Paged KV-cache block pool — the host-side allocator behind the
continuous-batching engine.

The device side is a pool of ``num_blocks`` fixed-size KV blocks per layer
(see ``repro_torch.models.transformer.init_paged_cache``); this module owns
the *mapping*: which physical blocks belong to which request, which are
free, and the padded per-slot block tables the engine step consumes.  Blocks hold
contiguous positions (logical position i of a request lives at offset
``i % block_size`` of its ``i // block_size``-th block), so device-side
validity is purely positional and the allocator never has to touch device
memory to recycle a block — stale contents are masked by the position gate
until overwritten.

Two-level accounting: admission **reserves** a block *budget* up front (so
a running request can never hit a mid-flight pool OOM) while physical
blocks are **mapped** lazily as positions are written.  This split is what
makes rollback and recycling cheap:

* ``truncate(slot, pos)`` — speculative-decode rollback: physical blocks
  wholly beyond ``pos`` return to the free list but their budget stays
  with the slot (the positions will be re-fed with accepted tokens);
* sliding-window recycling (``Scheduler.recycle_window``) frees blocks
  that fell out of the attention window the same way — and because a
  windowed slot's *budget* only covers the live window (not the full
  prompt+gen span), admission capacity for windowed archs scales with the
  window, not the sequence length.

Prefix sharing adds a per-block **refcount ledger**: a block attached by
several owners (the prefix tree plus any number of slots serving the same
prompt prefix) carries one reference per owner, ``free`` drops one
reference, and the block only returns to the free list at refcount 0.
``free(rereserve=True)`` on a still-shared block raises — speculative
rollback and window recycling re-credit a slot's private budget, and a
shared block was never part of it, so reclaiming one is structurally a
bug, not a policy choice.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class KVBlockPool:
    """Fixed-size block allocator (free-list) with a reservation ledger and
    per-block refcounts.  Raises on double-alloc / double-free /
    over-reserve / shared-block reclaim so scheduler bugs surface as
    exceptions, not silent KV corruption."""

    def __init__(self, num_blocks: int, block_size: int,
                 bytes_per_block: int = 0):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        # device-side cost of one block across all layers (payload + scale
        # planes for quantized pools — see transformer.paged_block_bytes);
        # 0 = unknown.  Pure metadata: capacity reports denominate in bytes,
        # admission stays block-granular.
        self.bytes_per_block = bytes_per_block
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._allocated: set = set()
        self._refcount: Dict[int, int] = {}  # allocated block -> owners
        self._reserved = 0          # budgeted-but-unmapped blocks

    # -- queries ------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    @property
    def num_reserved(self) -> int:
        return self._reserved

    @property
    def total_bytes(self) -> int:
        """Device bytes the whole pool costs (0 when untracked)."""
        return self.num_blocks * self.bytes_per_block

    @property
    def num_shared(self) -> int:
        """Blocks with more than one owner (prefix-cache sharing)."""
        return sum(1 for c in self._refcount.values() if c > 1)

    def refcount(self, block: int) -> int:
        """Owner count of an allocated block (0 for free blocks)."""
        return self._refcount.get(block, 0)

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` cache entries."""
        return -(-max(num_tokens, 0) // self.block_size)

    def can_allocate(self, n: int) -> bool:
        """Whether n blocks can be allocated OUTSIDE any reservation."""
        return n <= len(self._free) - self._reserved

    can_reserve = can_allocate      # same ledger: unreserved free blocks

    # -- reservation (admission-time budget) --------------------------------
    def reserve(self, n: int) -> None:
        if not self.can_reserve(n):
            raise RuntimeError(
                f"KV pool over-reserve: want {n} blocks, "
                f"{len(self._free) - self._reserved} unreserved free")
        self._reserved += n

    def release(self, n: int) -> None:
        if n > self._reserved:
            raise RuntimeError(f"release {n} > reserved {self._reserved}")
        self._reserved -= n

    # -- alloc / free -------------------------------------------------------
    def alloc(self, n: int, *, reserved: bool = False) -> List[int]:
        """Pop n physical blocks.  ``reserved=True`` draws them down from
        an existing reservation (always succeeds while the reservation
        invariant ``reserved <= free`` holds); ``reserved=False`` may only
        take unreserved blocks."""
        avail = len(self._free) if reserved else \
            len(self._free) - self._reserved
        if n > avail:
            raise RuntimeError(
                f"KV pool exhausted: want {n} blocks, {avail} "
                f"{'reserved-' if reserved else 'unreserved '}free")
        if reserved:
            self._reserved -= n
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        for b in out:
            self._refcount[b] = 1
        return out

    def incref(self, block: int) -> None:
        """Add an owner to an allocated block (prefix-cache attachment:
        the tree on insert, a slot on admission)."""
        if block not in self._allocated:
            raise RuntimeError(f"incref on unallocated block {block}")
        self._refcount[block] += 1

    def free(self, blocks: Sequence[int], *, rereserve: bool = False) -> None:
        """Drop one reference per block; blocks reaching refcount 0 return
        to the free list.  ``rereserve=True`` re-credits their budget
        (rollback/recycling: the slot keeps the right to map replacements)
        and therefore REFUSES still-shared blocks: a shared prefix block
        was never part of any slot's private budget, so reclaiming one
        through rollback/recycling is a scheduler bug."""
        if len(set(blocks)) != len(blocks):
            raise RuntimeError(f"duplicate blocks in free: {list(blocks)}")
        for b in blocks:      # validate before mutating anything
            if b not in self._allocated:
                raise RuntimeError(f"double-free / foreign block {b}")
            if rereserve and self._refcount[b] > 1:
                raise RuntimeError(
                    f"rereserve-free of shared block {b} "
                    f"(refcount {self._refcount[b]})")
        for b in blocks:
            if self._refcount[b] > 1:
                self._refcount[b] -= 1
                continue
            del self._refcount[b]
            self._allocated.remove(b)
            self._free.append(b)
        if rereserve:
            self._reserved += len(blocks)

    # -- speculative-decode rollback ----------------------------------------
    def truncate(self, slot, pos: int) -> int:
        """Roll a slot's mapping back to ``pos`` committed tokens: physical
        blocks wholly beyond the committed prefix (logical index >=
        ``blocks_for(pos)``) return to the free list, their budget going
        back to the slot (``slot.reserved``) so the positions can be
        re-mapped when real tokens arrive.  ``slot`` is duck-typed: it
        needs ``blocks`` (logical->physical list, −1 = unmapped) and a
        ``reserved`` counter.  Stale device contents need no touch — the
        position gate masks them until overwritten.  Returns the number of
        blocks reclaimed."""
        keep = self.blocks_for(pos)
        dead = [b for b in slot.blocks[keep:] if b >= 0]
        if dead:
            self.free(dead, rereserve=True)     # pool-wide ledger
            slot.reserved += len(dead)          # the slot's share of it
        del slot.blocks[keep:]
        return len(dead)

    def check_invariants(self) -> None:
        """free ∪ allocated must partition [0, num_blocks) exactly, the
        reservation ledger must be covered by free blocks, and the refcount
        ledger must cover exactly the allocated set with positive counts."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate block on the free list")
        if free & self._allocated:
            raise AssertionError(
                f"blocks both free and allocated: {free & self._allocated}")
        if free | self._allocated != set(range(self.num_blocks)):
            raise AssertionError("leaked or out-of-range blocks")
        if not 0 <= self._reserved <= len(self._free):
            raise AssertionError(
                f"reservation ledger broken: {self._reserved} reserved, "
                f"{len(self._free)} free")
        if set(self._refcount) != self._allocated:
            raise AssertionError(
                "refcount ledger out of sync with the allocated set: "
                f"{set(self._refcount) ^ self._allocated}")
        bad = {b: c for b, c in self._refcount.items() if c < 1}
        if bad:
            raise AssertionError(f"non-positive refcounts: {bad}")


def pad_block_table(blocks: Sequence[int], max_blocks: int) -> np.ndarray:
    """(max_blocks,) int32 table row; −1 marks unmapped logical blocks."""
    assert len(blocks) <= max_blocks, (len(blocks), max_blocks)
    row = np.full((max_blocks,), -1, np.int32)
    row[:len(blocks)] = blocks
    return row
