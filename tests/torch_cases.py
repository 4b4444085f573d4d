"""Numpy-only inputs shared by the PyTorch-port tests, including
the card-only ones, which run where JAX may not be installed."""
import numpy as np


def pools(rng, NB, bs, KV, D):
    """Random f32 (k_pool, v_pool), each (NB, bs, KV, D)."""
    return (rng.standard_normal((NB, bs, KV, D)).astype(np.float32),
            rng.standard_normal((NB, bs, KV, D)).astype(np.float32))


def paged_tables(rng, S, NB, bs, MB, T=1, unmapped=True):
    """Ragged block tables over shuffled physical blocks, with an
    unmapped (-1) early block in one slot and the last slot inactive.
    Returns (tables (S, MB) int32, start (S,) int32, n_tok (S,) int32,
    live (S, T) bool: live query tokens whose own key is mapped)."""
    tables = np.full((S, MB), -1, np.int32)
    perm = rng.permutation(NB)
    start = np.zeros((S,), np.int32)
    n_tok = np.zeros((S,), np.int32)
    off = 0
    for s in range(S):
        n = int(rng.integers(1, MB + 1))
        tables[s, :n] = perm[off:off + n]
        off += n
        n_tok[s] = int(rng.integers(1, T + 1))
        start[s] = int(rng.integers(max(n - 2, 0) * bs,
                                    n * bs - int(n_tok[s]) + 1))
    start[-1], n_tok[-1] = -1, 0
    if unmapped and MB > 1 and S > 1 and start[0] >= bs:
        tables[0, 0] = -1
    live = np.zeros((S, T), bool)
    for s in range(S - 1):
        for t in range(int(n_tok[s])):
            live[s, t] = tables[s, (start[s] + t) // bs] >= 0
    return tables, start, n_tok, live
