"""Byte-pair-encoding tokenizer, trained from scratch — nanochat ships a Rust
BPE; this is the same algorithm in pure Python/numpy (our corpora are small).

Byte-level: the base alphabet is the 256 byte values; merges are learned
greedily by pair frequency.  Special tokens follow nanochat's chat schema
(<|bos|>, <|user_start|> … <|assistant_end|>) so the mid-training/SFT stages
can format dialogues exactly like the paper's pipeline.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

SPECIAL_TOKENS = [
    "<|bos|>", "<|user_start|>", "<|user_end|>",
    "<|assistant_start|>", "<|assistant_end|>", "<|pad|>",
]


class BPETokenizer:
    def __init__(self, merges: List[Tuple[int, int]],
                 special_tokens: Optional[List[str]] = None):
        self.merges = merges
        self.special = special_tokens or list(SPECIAL_TOKENS)
        self._rank: Dict[Tuple[int, int], int] = {
            tuple(m): i for i, m in enumerate(merges)}
        self._special_base = 256 + len(merges)
        self._special_ids = {s: self._special_base + i
                             for i, s in enumerate(self.special)}

    # -- vocab ----------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.special)

    def special_id(self, tok: str) -> int:
        return self._special_ids[tok]

    @property
    def bos(self) -> int:
        return self._special_ids["<|bos|>"]

    @property
    def pad(self) -> int:
        return self._special_ids["<|pad|>"]

    # -- train ------------------------------------------------------------------
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int,
              special_tokens: Optional[List[str]] = None) -> "BPETokenizer":
        special = special_tokens or list(SPECIAL_TOKENS)
        n_merges = vocab_size - 256 - len(special)
        assert n_merges >= 0, "vocab_size too small"
        # work on word chunks (whitespace-split) to keep pair counting cheap
        words = Counter()
        for t in texts:
            for w in t.split(" "):
                words[tuple((w + " ").encode("utf-8"))] += 1
        merges: List[Tuple[int, int]] = []
        seqs = {w: list(w) for w in words}
        for merge_i in range(n_merges):
            pairs: Counter = Counter()
            for w, cnt in words.items():
                s = seqs[w]
                for a, b in zip(s, s[1:]):
                    pairs[(a, b)] += cnt
            if not pairs:
                break
            (a, b), freq = pairs.most_common(1)[0]
            if freq < 2:
                break
            new_id = 256 + merge_i
            merges.append((a, b))
            for w in words:
                s = seqs[w]
                out, i = [], 0
                while i < len(s):
                    if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                        out.append(new_id)
                        i += 2
                    else:
                        out.append(s[i])
                        i += 1
                seqs[w] = out
        return cls(merges, special)

    # -- encode/decode ------------------------------------------------------------
    def _encode_chunk(self, data: bytes) -> List[int]:
        s = list(data)
        while len(s) >= 2:
            best, best_rank = None, None
            for i, pair in enumerate(zip(s, s[1:])):
                r = self._rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            new_id = 256 + best_rank
            s = s[:best] + [new_id] + s[best + 2:]
        return s

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids: List[int] = [self.bos] if add_bos else []
        # split out special tokens first
        rest = [text]
        for sp in self.special:
            nxt = []
            for part in rest:
                if isinstance(part, int):
                    nxt.append(part)
                    continue
                pieces = part.split(sp)
                for j, piece in enumerate(pieces):
                    if j:
                        nxt.append(self._special_ids[sp])
                    if piece:
                        nxt.append(piece)
            rest = nxt
        for part in rest:
            if isinstance(part, int):
                ids.append(part)
            else:
                for w in part.split(" "):
                    ids.extend(self._encode_chunk((w + " ").encode("utf-8")))
        return ids

    def decode(self, ids: List[int]) -> str:
        # expand merges
        table: List[bytes] = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            table.append(table[a] + table[b])
        out = b""
        for i in ids:
            if i >= self._special_base:
                out += self.special[i - self._special_base].encode("utf-8")
            elif i < len(table):
                out += table[i]
        return out.decode("utf-8", errors="replace")

    # -- persistence -----------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges, "special": self.special}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        return cls([tuple(m) for m in d["merges"]], d["special"])
