"""Prompt-lookup / n-gram drafter for speculative decoding.

A zero-parameter host-side proposer (the "self-drafting" in self-drafting
slots): the draft for a slot is whatever followed the most recent earlier
occurrence of the slot's current suffix n-gram in its OWN token history
(prompt + generated so far).  No extra model, no device work — the cost is
a numpy sliding-window match over a few hundred ints, amortized against a
full model forward.  This is the prompt-lookup decoding trick
(transformers' ``prompt_lookup_num_tokens``): extremely effective on
extraction/summarization-style traffic and on the repetitive tails greedy
decoding produces, and harmless (drafts are simply rejected) elsewhere.

The drafter is intentionally *deterministic*: a slot's proposal is a pure
function of its own history, so speculative sampling keyed by
``(seed, rid, position)`` stays schedule-independent — which requests
shared the batch can never change another request's tokens.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _match_once(arr: np.ndarray, k: int, max_n: int, min_n: int
                ) -> List[int]:
    """One suffix-n-gram lookup over ``arr``; up to ``k`` continuation
    tokens from the most recent earlier occurrence, [] on miss."""
    H = len(arr)
    for n in range(min(max_n, H - 1), min_n - 1, -1):
        suffix = arr[H - n:]
        # windows [i, i+n) over everything before the suffix's last token,
        # so a match always has at least one continuation token
        win = np.lib.stride_tricks.sliding_window_view(arr[:H - 1], n)
        hits = np.nonzero((win == suffix).all(axis=1))[0]
        if hits.size:
            i = int(hits[-1])                 # most recent occurrence
            cont = arr[i + n:i + n + k]
            if cont.size:
                return [int(t) for t in cont]
    return []


def propose(history: Sequence[int], k: int, max_n: int = 3,
            min_n: int = 1) -> List[int]:
    """Draft up to ``k`` tokens continuing ``history``.

    Matches the longest suffix n-gram (``max_n`` down to ``min_n``) against
    the rest of the history; on a hit, proposes the tokens that followed
    the MOST RECENT earlier occurrence.  When the match lands near the end
    of the history the continuation truncates, so matching re-runs on the
    extended sequence until the budget fills or a lookup misses — on a
    periodic tail (the common greedy regime) this unrolls the loop to the
    full ``k`` instead of stopping at the period.  Returns [] when nothing
    matches (the engine then falls back to plain one-token decoding for
    the round)."""
    H = len(history)
    if k <= 0 or H < min_n + 1:
        return []
    arr = np.asarray(history, dtype=np.int64)
    out: List[int] = []
    while len(out) < k:
        cont = _match_once(arr, k - len(out), max_n, min_n)
        if not cont:
            break
        out.extend(cont)
        arr = np.concatenate([arr, np.asarray(cont, np.int64)])
    return out
