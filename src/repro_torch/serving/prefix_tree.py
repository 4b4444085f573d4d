"""Radix tree over token sequences mapping shared prompt prefixes to
refcounted physical KV blocks — the prefix cache behind cache-aware
admission.

Granularity is one node per KV block: a node's ``key`` is the
``block_size``-token chunk (shorter for a boundary leaf) whose KV lives in
``node.block``.  Chat-style traffic repeats the same system-prompt /
template prefix across requests, so the tree turns those identical leading
chunks into ONE physical block each: a request whose prompt walks matched
full-block nodes attaches those blocks at admission (refcount bumped per
attachment), reserves budget only for its unshared tail, and starts
decoding at ``pos = matched_len`` — the prefill compute and the pool bytes
for the shared prefix are both skipped.

Sharing rules:

* **full blocks are shared in place** — every position in the block is
  prompt prefix, written once at the original prefill and never rewritten
  (generated tokens land at positions ≥ prompt length, speculative
  rollback never rewinds below the committed prompt), so concurrent
  readers are safe;
* **the boundary partial block is copy-on-write** — a block whose key is a
  strict prefix of its tokens (or a full block matched only partially)
  also holds positions the new request must write, so the match returns a
  *fork*: the scheduler allocates a private block from the request's own
  budget and the engine copies the source block's device contents before
  the first step.  Positions beyond the fork's valid length are stale
  garbage masked by the position gate until overwritten, exactly like any
  freshly mapped block;
* a match never covers the whole prompt — at least one token is left to
  prefill so the step produces the logits the first sampled token comes
  from (``matched_len <= len(prompt) - 1``).

Ownership: the tree holds ONE pool reference per node
(``KVBlockPool.incref`` on insert); each attached slot holds its own.
``evict`` only removes childless nodes whose refcount is exactly the
tree's own (no slot attached), LRU-first by a logical access clock, so a
block is returned to the free list precisely when the last owner lets go.
``max_blocks`` bounds how many blocks the cache may keep resident;
admission-pressure eviction (``Scheduler.admit``) shrinks it further when
a waiting request's tail budget doesn't fit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.kv_cache import KVBlockPool


@dataclasses.dataclass
class _Node:
    key: Tuple[int, ...]            # the block's token chunk
    block: int                      # physical block id (tree holds 1 ref)
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = \
        dataclasses.field(default_factory=dict)
    last_use: int = 0

    @property
    def full(self) -> bool:
        return self.parent is not None and len(self.key) > 0


@dataclasses.dataclass
class Match:
    """Result of a prefix lookup.  ``blocks`` are full shared blocks to
    attach (refcounts NOT yet bumped — admission does that); ``fork_src``
    is the boundary block to copy-on-write (None = clean block boundary),
    valid for the first ``matched_len - block_size * len(blocks)``
    positions of the forked block."""
    blocks: List[int]
    matched_len: int
    fork_src: Optional[int] = None

    @property
    def hit(self) -> bool:
        return self.matched_len > 0


class PrefixTree:
    def __init__(self, block_size: int, max_blocks: int = 0):
        """``max_blocks``: LRU bound on resident cache blocks (0 = only
        bounded by the pool itself)."""
        assert block_size > 0
        self.block_size = block_size
        self.max_blocks = int(max_blocks)
        self.root = _Node(key=(), block=-1, parent=None)
        self._clock = 0
        self._nodes = 0
        # observability (reset by the scheduler per run if desired)
        self.hits = 0
        self.misses = 0
        self.matched_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    # -- queries ------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        """Blocks currently resident in the cache (== tree nodes)."""
        return self._nodes

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt: List[int], *, touch: bool = True) -> Match:
        """Longest shared prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens.  ``touch=False`` is a side-effect-free
        dry run (used by the ``cache_aware`` admission policy to rank
        waiting requests without perturbing LRU order)."""
        bs = self.block_size
        limit = len(prompt) - 1
        node, blocks, matched = self.root, [], 0
        while matched + bs <= limit:
            child = node.children.get(tuple(prompt[matched:matched + bs]))
            if child is None:
                break
            blocks.append(child.block)
            matched += bs
            node = child
            if touch:
                child.last_use = self._tick()
        # boundary: the longest child whose key prefix-matches the
        # remaining tokens gives a copy-on-write fork
        fork_src, fork_len = None, 0
        remaining = prompt[matched:limit]
        for child in node.children.values():
            n = 0
            for a, b in zip(child.key, remaining):
                if a != b:
                    break
                n += 1
            if n > fork_len:
                fork_src, fork_len = child, n
        if fork_src is not None and touch:
            fork_src.last_use = self._tick()
        return Match(blocks=blocks, matched_len=matched + fork_len,
                     fork_src=fork_src.block if fork_src else None)

    # -- insertion ----------------------------------------------------------
    def insert(self, prompt: List[int], blocks: List[int],
               pool: KVBlockPool) -> int:
        """Register a prefilled prompt's blocks: full chunks become full
        nodes, a non-aligned tail becomes a partial leaf.  Blocks already
        represented (a concurrent request prefilled the same prefix) are
        left in place — the tree keeps ONE block per chunk.  New nodes take
        their own pool reference.  Returns the number of blocks newly
        inserted."""
        bs = self.block_size
        node, added, i = self.root, 0, 0
        while (i + 1) * bs <= len(prompt):
            chunk = tuple(prompt[i * bs:(i + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                if blocks[i] < 0:       # unmapped (windowed/partial prefill)
                    return added
                child = _Node(key=chunk, block=blocks[i], parent=node)
                pool.incref(blocks[i])
                node.children[chunk] = child
                self._nodes += 1
                added += 1
            child.last_use = self._tick()
            node = child
            i += 1
        tail = tuple(prompt[i * bs:])
        if tail and i < len(blocks) and blocks[i] >= 0 \
                and tail not in node.children:
            leaf = _Node(key=tail, block=blocks[i], parent=node)
            pool.incref(blocks[i])
            node.children[tail] = leaf
            leaf.last_use = self._tick()
            self._nodes += 1
            added += 1
        self.inserted_blocks += added
        if self.max_blocks:
            self.evict(pool, max(self._nodes - self.max_blocks, 0))
        return added

    # -- eviction -----------------------------------------------------------
    def _evictable(self, pool: KVBlockPool) -> List[_Node]:
        """Childless nodes no slot is attached to (refcount == the tree's
        own), LRU-first."""
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.parent is not None and not n.children \
                    and pool.refcount(n.block) == 1:
                out.append(n)
        out.sort(key=lambda n: n.last_use)
        return out

    def evict(self, pool: KVBlockPool, n: int) -> int:
        """Drop up to ``n`` LRU leaves, freeing their blocks.  Evicting a
        leaf can expose its parent; the scan repeats until ``n`` blocks
        went or nothing is evictable.  Returns blocks actually freed."""
        freed = 0
        while freed < n:
            leaves = self._evictable(pool)
            if not leaves:
                break
            for leaf in leaves[:n - freed]:
                pool.free([leaf.block])
                del leaf.parent.children[leaf.key]
                self._nodes -= 1
                freed += 1
        self.evicted_blocks += freed
        return freed

    def evict_for(self, pool: KVBlockPool, need: int) -> int:
        """Admission-pressure eviction: free LRU cache blocks until the
        pool can reserve ``need`` blocks (or nothing is evictable).
        Returns blocks freed."""
        freed = 0
        while not pool.can_reserve(need) and self.evict(pool, 1):
            freed += 1
        return freed

    def report(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "shared_blocks": self._nodes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "matched_tokens": self.matched_tokens,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
        }
