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


def split_inputs(seed, S=4, T=5, KV=2, G=1, D=32, bs=16, MB=16, chunk=64):
    """Paged verify inputs whose caches span at least three chunks of
    ``chunk`` key positions: slot 0's T tokens straddle the first chunk
    boundary, slot 1 ends at the cache's last position with an unmapped
    block midway, slot 2 starts in its unmapped first block (no key to
    attend), the last slot is inactive, any others are random.  Returns
    numpy q (S, T, KV, G, D), k_pool, v_pool (NB, bs, KV, D), tables
    (S, MB), start (S,), n_tok (S,) and live (S, T): live tokens whose own
    key is mapped."""
    rng = np.random.default_rng(seed)
    cap = MB * bs
    assert S >= 4 and T >= 3 and cap >= 3 * chunk
    start = np.full((S,), -1, np.int32)
    n_tok = np.zeros((S,), np.int32)
    start[:3], n_tok[:3] = (chunk - 2, cap - T, 1), (T, T, 2)
    for s in range(3, S - 1):
        start[s] = rng.integers(0, cap - T + 1)
        n_tok[s] = rng.integers(1, T + 1)
    NB = S * MB
    perm = rng.permutation(NB)
    tables = np.full((S, MB), -1, np.int32)
    for s in range(S - 1):
        n = (start[s] + n_tok[s] - 1) // bs + 1
        tables[s, :n] = perm[s * MB:s * MB + n]
    tables[1, MB // 2] = -1
    tables[2, 0] = -1
    q = rng.standard_normal((S, T, KV, G, D)).astype(np.float32)
    k_pool, v_pool = pools(rng, NB, bs, KV, D)
    live = np.zeros((S, T), bool)
    for s in range(S - 1):
        for t in range(int(n_tok[s])):
            live[s, t] = tables[s, (start[s] + t) // bs] >= 0
    return q, k_pool, v_pool, tables, start, n_tok, live


def ssd_inputs(seed, B, S, H, P, N, D_val=1.0):
    """SSD scan inputs as f32 arrays, distributed as the JAX package's
    kernel tests draw them: x, Bm, Cm normal, dt = softplus(normal),
    A = -exp(U[0, 1)), D = ``D_val``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.uniform(size=(H,)))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    D = np.full((H,), D_val, np.float32)
    return x, dt, A, Bm, Cm, D


def ring_inputs(seed, B, KV, G, S, D, dead_row=True):
    """q, k, v (f32) and a wrapped ring: the first 3/4 of the slots hold
    positions counting down from q_pos - 1 modulo the row's fill, the rest
    are empty (-1); with ``dead_row`` the last row's query sits at -1 (a
    left-pad token: no live key).  Returns numpy arrays and the live-row
    mask (B,)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    fill = 3 * S // 4
    base = rng.integers(fill, fill + 100, (B, 1))
    pos = (base - 1 - np.arange(S)[None, :]) % (base + 1)
    pos = np.where(np.arange(S)[None, :] < fill, pos, -1).astype(np.int32)
    q_pos = base[:, 0].astype(np.int32)
    live = np.ones((B,), bool)
    if dead_row:
        q_pos[-1] = -1
        live[-1] = False
    return q, k, v, pos, q_pos, live
