"""Token pipeline: packing, deterministic batch sampling, per-worker
sharding — a copy of the numpy-only part of the JAX package's
``data/pipeline.py`` (``PackedDataset``, ``build_tokenizer``); the tests
hold the copy to the original — and the chunked training loop's batch
source (``stack_batches``, ``Prefetcher``), in torch.

DiLoCo semantics require each worker to consume a *disjoint* data stream (the
paper shards FineWeb-Edu across the 8 GPUs).  ``worker_batches`` dedicates a
non-overlapping region of the packed token stream per worker and samples from
it with a step-seeded PRNG, so runs are exactly reproducible and DDP-vs-DiLoCo
comparisons consume identical token budgets.

``Prefetcher`` feeds the chunked ``DistTrainer`` loop: a background
thread runs ``data_fn`` (host RNG, gather, stacking) ahead of the
training loop, so batch assembly overlaps device compute instead of
serialising with it.  Batches are pure functions of the step index, so
running ahead is trivially correct.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.tokenizer import BPETokenizer


@dataclasses.dataclass
class PackedDataset:
    tokens: np.ndarray            # (N,) int32 contiguous packed stream
    seq_len: int

    @classmethod
    def from_texts(cls, texts: List[str], tok: BPETokenizer, seq_len: int,
                   add_bos: bool = True) -> "PackedDataset":
        ids: List[int] = []
        for t in texts:
            ids.extend(tok.encode(t, add_bos=add_bos))
        arr = np.asarray(ids, np.int32)
        need = seq_len + 1
        if len(arr) < 2 * need:  # make sampling well-defined on tiny corpora
            reps = int(np.ceil(2 * need / max(len(arr), 1)))
            arr = np.tile(arr, reps)
        return cls(arr, seq_len)

    @property
    def num_tokens(self) -> int:
        return int(self.tokens.size)

    def _sample(self, rng: np.random.Generator, batch: int,
                lo: int, hi: int) -> Dict[str, np.ndarray]:
        need = self.seq_len + 1
        hi = max(hi - need, lo + 1)
        starts = rng.integers(lo, hi, size=batch)
        chunk = np.stack([self.tokens[s:s + need] for s in starts])
        return {"tokens": chunk[:, :-1].astype(np.int32),
                "labels": chunk[:, 1:].astype(np.int32)}

    def batch(self, step: int, batch: int, seed: int = 0
              ) -> Dict[str, np.ndarray]:
        """Merged (DDP) batch."""
        rng = np.random.default_rng((seed, step))
        return self._sample(rng, batch, 0, self.num_tokens)

    def worker_batches(self, step: int, num_workers: int, per_worker: int,
                       seed: int = 0) -> Dict[str, np.ndarray]:
        """(K, B, S) stacked batches from disjoint per-worker shards."""
        shard = self.num_tokens // num_workers
        outs = []
        for w in range(num_workers):
            rng = np.random.default_rng((seed, step, w))
            outs.append(self._sample(rng, per_worker,
                                     w * shard, (w + 1) * shard))
        return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


def build_tokenizer(texts: List[str], vocab_size: int) -> BPETokenizer:
    return BPETokenizer.train(texts, vocab_size)


# ---------------------------------------------------------------------------
# Batch source for the chunked training loop
# ---------------------------------------------------------------------------

def stack_batches(batches: List[Dict], device=None) -> Dict[str, torch.Tensor]:
    """Stack per-step batches ``{name: (K, B, S)}`` into one chunk with a
    leading T dim on ``device`` (None: the CPU).  Host (numpy) leaves are
    stacked on the host and moved to the device in ONE copy per leaf per
    chunk; tensor leaves are stacked where they lie, then moved."""
    out = {}
    for name in batches[0]:
        xs = [b[name] for b in batches]
        if all(isinstance(x, np.ndarray) for x in xs):
            t = torch.from_numpy(np.stack(xs))
        else:
            t = torch.stack([torch.as_tensor(x) for x in xs])
        out[name] = t if device is None else t.to(device)
    return out


class Prefetcher:
    """Double-buffered async batch source for ``DistTrainer``'s chunked loop.

    A daemon thread produces ``data_fn(step)`` for steps ``start..N-1`` in
    order and parks each host batch in a bounded queue ``depth`` steps
    ahead of the consumer, so batch assembly overlaps device compute.
    ``take(start, n)`` pops the next ``n`` consecutive batches and stacks
    them into one (T, ...) chunk on ``device`` (``stack_batches``); the
    loop consumes steps strictly in order, so the queue IS the schedule.
    Producer exceptions surface on the consuming thread at the next
    ``take``.
    """

    _DONE = object()

    def __init__(self, data_fn: Callable[[int], Dict], num_steps: int,
                 depth: int = 8, start: int = 0, device=None):
        self.data_fn = data_fn
        self.num_steps = num_steps
        self.start = int(start)     # resume cursor: produce start..N-1
        self.device = device
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._pending: List = []        # items popped by prime(), unconsumed
        self._primed = None             # (start, n, box) of an async chunk
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for step in range(self.start, self.num_steps):
                item = (step, self.data_fn(step))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except Exception as e:  # surfaced by the consumer's next take()
            self._err = e
            self._q.put((None, self._DONE))

    def _next_item(self):
        """Next (step, batch) in order: primed leftovers first, then the
        producer queue."""
        if self._pending:
            return self._pending.pop(0)
        return self._q.get()

    def prime(self, start: int, n: int) -> None:
        """Start assembling the chunk for steps ``start .. start + n - 1``
        (pop, host stack, copy to the device) on a background thread, so
        it overlaps whatever the caller does next — in ``DistTrainer``, the
        outer sync at the chunk boundary.

        Purely an optimization: ``take`` consumes a primed chunk when the
        bounds match exactly and falls back to the raw items otherwise, so
        priming never changes what ``take`` returns."""
        n = min(n, self.num_steps - start)
        if self._primed is not None or n <= 0:
            return
        box = {"done": threading.Event()}

        def work():
            try:
                raw = []
                for _ in range(n):
                    item = self._next_item()
                    raw.append(item)
                    if item[1] is self._DONE:
                        break            # producer died: nothing follows
                box["raw"] = raw
                if len(raw) == n and not any(b is self._DONE
                                             for _, b in raw):
                    box["chunk"] = stack_batches([b for _, b in raw],
                                                 self.device)
            except Exception as e:   # surfaces at the matching take()
                box["err"] = e
            box["done"].set()

        self._primed = (start, n, box)
        threading.Thread(target=work, daemon=True).start()

    def take(self, start: int, n: int) -> Dict[str, torch.Tensor]:
        """Stacked chunk for steps ``start .. start + n - 1``."""
        if self._primed is not None:
            pstart, pn, box = self._primed
            self._primed = None
            box["done"].wait()
            if "err" in box:
                raise box["err"]
            if pstart == start and pn == n and "chunk" in box:
                self._check_order(box["raw"], start)
                return box["chunk"]
            # bounds moved (or the producer died mid-chunk): keep the raw
            # items and fall through to the synchronous path
            self._pending = box["raw"] + self._pending
        out = []
        for i in range(n):
            step, batch = self._next_item()
            if batch is self._DONE:
                if self._err is not None:
                    # the producer's own exception, traceback into data_fn
                    raise self._err
                raise RuntimeError(
                    "prefetcher producer stopped (closed) before step "
                    f"{start + i}")
            if step != start + i:
                raise RuntimeError(
                    f"prefetcher consumed out of order: wanted {start + i}, "
                    f"queue held {step} (take() must walk steps in order)")
            out.append(batch)
        return stack_batches(out, self.device)

    @staticmethod
    def _check_order(raw, start: int) -> None:
        for i, (step, batch) in enumerate(raw):
            if batch is not Prefetcher._DONE and step != start + i:
                raise RuntimeError(
                    f"prefetcher consumed out of order: wanted {start + i}, "
                    f"queue held {step} (take() must walk steps in order)")

    def close(self):
        self._stop.set()
        while True:     # unblock a producer parked on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._primed is not None:
            # wake a prime worker parked on the drained queue (it exits at
            # the first _DONE it pops) so it cannot outlive the run
            _, _, box = self._primed
            self._primed = None
            self._q.put((None, self._DONE))
            box["done"].wait(timeout=5)
        self._pending.clear()
        self._thread.join(timeout=5)
