"""Token pipeline: packing, deterministic batch sampling, per-worker
sharding — a copy of the numpy-only part of the JAX package's
``data/pipeline.py`` (``PackedDataset``, ``build_tokenizer``); the tests
hold the copy to the original.

DiLoCo semantics require each worker to consume a *disjoint* data stream (the
paper shards FineWeb-Edu across the 8 GPUs).  ``worker_batches`` dedicates a
non-overlapping region of the packed token stream per worker and samples from
it with a step-seeded PRNG, so runs are exactly reproducible and DDP-vs-DiLoCo
comparisons consume identical token budgets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

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
