"""The split-key design of the port's decode kernels, on the CPU: the
plain mirror of the split and the combine (``*_split_plain``,
``combine_partials`` in ``kernels/decode_attention/ref.py``) against the
unsplit plain versions, the JAX oracles and the interpret-mode Pallas
kernels (f32, atol 1e-5, live rows), and the properties the CUDA kernels
keep: verify row t equals decode at start + t bit for bit, an empty chunk
is an exact identity in the combine, a row with no key gives zeros.  The
chunk count comes from shapes alone.  The kernels themselves are held to
the same properties on a card (``tests/test_torch_cuda.py``)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_ring
from repro.kernels.decode_attention import (
    paged_decode_attention as pallas_paged_decode,
    paged_decode_attention_dequant as pallas_paged_decode_dequant,
    paged_verify_attention as pallas_paged_verify,
    paged_verify_attention_dequant as pallas_paged_verify_dequant,
    reference_decode_attention, reference_paged_decode_attention,
    reference_paged_decode_attention_dequant,
    reference_paged_verify_attention,
    reference_paged_verify_attention_dequant)
from repro.kernels.quantize import reference_quantize_axis
from repro_torch.kernels.decode_attention import ops, ref
from torch_cases import ring_inputs, split_inputs

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

ATOL = 1e-5
CHUNK = 16                      # key positions per chunk at these sizes
SHAPE = dict(S=4, T=4, KV=2, G=2, D=32, bs=8, MB=8, chunk=CHUNK)  # 4 chunks
POOLS = ["float32", "bfloat16", "int8", "fp8_e4m3", "fp8_e5m2", "fp8_qk"]


def _to_torch(x) -> torch.Tensor:
    """numpy / jax array -> torch, fp8 payloads through their bytes."""
    a = np.asarray(x)
    names = {"float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}
    if a.dtype.name in names:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            names[a.dtype.name])
    return torch.from_numpy(a.copy())


def _inputs(seed, pool, **shape):
    """split_inputs as torch tensors with the pool as ``pool``: quantized
    with the JAX oracle for a quantize target.  Returns (q, kv list (k,
    v[, k_scale, v_scale]), tables, start, n_tok, live, jax kv list,
    dequant?, fp8?)."""
    q, kp, vp, tab, start, n_tok, live = split_inputs(
        seed, **{**SHAPE, **shape})
    if pool in ("int8", "fp8_e4m3", "fp8_e5m2"):
        jkv = []
        for p in (kp, vp):
            qq, s = reference_quantize_axis(jnp.asarray(p), axis=-1,
                                            dtype=pool)
            jkv.append((qq, s[..., 0]))
        jkv = [jkv[0][0], jkv[1][0], jkv[0][1], jkv[1][1]]
        kv = [_to_torch(a) for a in jkv]
    else:
        dt = torch.float32 if pool == "fp8_qk" else getattr(torch, pool)
        kv = [torch.from_numpy(p).to(dt) for p in (kp, vp)]
        jkv = [jnp.asarray(t.float().numpy()) for t in kv]
    return (torch.from_numpy(q), kv, *(torch.from_numpy(a) for a in
                                       (tab, start, n_tok)), live, jkv,
            len(kv) == 4, pool == "fp8_qk")


def _split(step, q, kv, tab, pos, window, fp8, dequant, chunk=CHUNK):
    """The mirror of ``step`` ("decode" / "verify"): kv (k, v[, scales]),
    pos (q_pos,) or (start, n_tok)."""
    fn = getattr(ref, f"paged_{step}_split_plain")
    scales = tuple(kv[2:]) if dequant else (None, None)
    return fn(q, kv[0], kv[1], tab, *pos, window, fp8, *scales,
              chunk_keys=chunk)


def _plain(step, q, kv, tab, pos, window, fp8, dequant):
    sfx = "_dequant" if dequant else ""
    fn = getattr(ref, f"paged_{step}_attention{sfx}_plain")
    return fn(q, *kv, tab, *pos, window, *(() if dequant else (fp8,)))


# ---------------------------------------------------------------------------
# The mirror against the unsplit plain versions and the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("step", ["decode", "verify"])
@pytest.mark.parametrize("window", [0, 20])
def test_split_mirror_matches_unsplit_plain(pool, step, window):
    """Over 4 chunks, a verify range across a chunk boundary, an unmapped
    block midway, a slot whose only block is unmapped, an inactive
    slot."""
    q, kv, tab, start, n_tok, live, _, dequant, fp8 = _inputs(
        POOLS.index(pool) + window, pool)
    if step == "decode":
        q, pos, live = q[:, 0].contiguous(), (start,), live[:, 0]
    else:
        pos = (start, n_tok)
    got = _split(step, q, kv, tab, pos, window, fp8, dequant)
    want = _plain(step, q, kv, tab, pos, window, fp8, dequant)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.float().numpy()[live],
                               want.float().numpy()[live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["float32", "int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("step", ["decode", "verify"])
@pytest.mark.parametrize("window", [0, 20])
def test_split_mirror_matches_jax_oracle_and_pallas(pool, step, window):
    """The mirror against the JAX oracle and the Pallas kernel in interpret
    mode, plain and dequant pools (the JAX kernels' rows with no key are
    the mean of V: live rows only)."""
    q, kv, tab, start, n_tok, live, jkv, dequant, _ = _inputs(
        7 + POOLS.index(pool) + window, pool)
    if step == "decode":
        q, pos, live = q[:, 0].contiguous(), (start,), live[:, 0]
    else:
        pos = (start, n_tok)
    got = _split(step, q, kv, tab, pos, window, False, dequant).numpy()
    jargs = [jnp.asarray(q.numpy()), *jkv, jnp.asarray(tab.numpy()),
             *(jnp.asarray(p.numpy()) for p in pos)]
    sfx = "_dequant" if dequant else ""
    oracle = {("decode", ""): reference_paged_decode_attention,
              ("verify", ""): reference_paged_verify_attention,
              ("decode", "_dequant"): reference_paged_decode_attention_dequant,
              ("verify", "_dequant"): reference_paged_verify_attention_dequant
              }[(step, sfx)]
    pallas = {("decode", ""): pallas_paged_decode,
              ("verify", ""): pallas_paged_verify,
              ("decode", "_dequant"): pallas_paged_decode_dequant,
              ("verify", "_dequant"): pallas_paged_verify_dequant}[(step, sfx)]
    for want in (oracle(*jargs, window=window),
                 pallas(*jargs, window=window, interpret=True)):
        np.testing.assert_allclose(got[live], np.asarray(want)[live],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,KV,G,S,D,window,chunk,bk", [
    (3, 2, 2, 200, 32, 0, 64, 50),      # S not a multiple of the chunk
    (3, 2, 2, 200, 32, 40, 64, 50),     # a window starting mid-chunk
    (2, 1, 4, 256, 64, 64, 32, 128),
    (2, 2, 3, 100, 16, 0, 16, 50)])
def test_ring_split_mirror_matches_plain_jax_and_pallas(B, KV, G, S, D, window,
                                                        chunk, bk):
    """The ring split with a whole chunk of dead slots (row 0), a rotated
    ring (row 1) and a row with no live key (the last: zeros); the Pallas
    kernel's key block ``bk`` divides S."""
    q, k, v, pos, q_pos, live = ring_inputs(S + D, B, KV, G, S, D)
    pos[0, chunk:2 * chunk] = -1
    pos[1] = np.roll(pos[1], S // 3)
    args = [torch.from_numpy(a) for a in (q, k, v, pos, q_pos)]
    got = ref.decode_attention_split_plain(*args, window, chunk_keys=chunk)
    assert bool((got[~torch.from_numpy(live)] == 0).all())
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, q_pos)]
    for want in (ref.decode_attention_plain(*args, window).numpy(),
                 reference_decode_attention(*jargs, window=window),
                 jax_ring(*jargs, window=window, bk=bk)):
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The properties the kernels keep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("G,window", [(1, 0), (2, 0), (1, 20), (2, 20)])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_split_mirror_verify_rows_equal_decode_bit_for_bit(pool, G, window,
                                                           chunk):
    """verify(q)[:, t] == decode(q[:, t]) at q_pos = start + t (-1 for a
    padding token), to the bit, on every pool and with the fp8 QK^T, over
    chunks smaller than, equal to and larger than a block run."""
    q, kv, tab, start, n_tok, *_, dequant, fp8 = _inputs(
        G + window + chunk, pool, KV=4 // G, G=G)
    got = _split("verify", q, kv, tab, (start, n_tok), window, fp8, dequant,
                 chunk)
    for t in range(q.shape[1]):
        q_pos = torch.where((t < n_tok) & (start >= 0), start + t, -1).int()
        one = _split("decode", q[:, t].contiguous(), kv, tab, (q_pos,),
                     window, fp8, dequant, chunk)
        assert torch.equal(got[:, t], one), t


@pytest.mark.parametrize("seed", range(3))
def test_combine_empty_chunk_is_an_exact_identity(seed):
    """Inserting an empty partial (m = -inf, with NaN l and acc, which the
    combine never reads) anywhere among a row's chunks changes no bit;
    chunk weights are exp(m_c - M), exactly 1 for the max's chunk."""
    rng = np.random.default_rng(seed)
    R, nc, D = 6, 4, 16
    m = torch.from_numpy(rng.standard_normal((R, nc)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 5, (R, nc)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((R, nc, D))
                           .astype(np.float32))
    m[0, 1:] = -np.inf                   # a row with one non-empty chunk
    base = ref.combine_partials(m, l, acc)
    np.testing.assert_array_equal(base[0].numpy(),
                                  (acc[0, 0] / l[0, 0]).numpy())
    for at in range(nc + 1):
        m2 = torch.cat([m[:, :at], torch.full((R, 1), -np.inf), m[:, at:]], 1)
        l2 = torch.cat([l[:, :at], torch.full((R, 1), np.nan), l[:, at:]], 1)
        a2 = torch.cat([acc[:, :at], torch.full((R, 1, D), np.nan),
                        acc[:, at:]], 1)
        assert torch.equal(ref.combine_partials(m2, l2, a2), base), at


def test_split_mirror_rows_without_a_key_are_zeros():
    """The inactive slot, padding tokens (t >= n_tok) and the slot whose
    only block is unmapped come out as exact zeros, decode and verify, as
    from the kernels (the unsplit plain versions give garbage there)."""
    q, kv, tab, start, n_tok, live, *_ = _inputs(3, "float32")
    got = _split("verify", q, kv, tab, (start, n_tok), 0, False, False)
    empty = torch.arange(q.shape[1])[None, :] >= n_tok[:, None]
    empty[2] = True                      # slot 2's one block is unmapped
    assert bool(empty[-1].all()) and not bool(empty[0].any())
    assert bool((got[empty] == 0).all())
    assert bool((got[~empty].abs().amax(-1) > 0).all())
    one = _split("decode", q[:, 0].contiguous(), kv, tab, (start,), 0,
                 False, False)
    assert bool((one[[2, 3]] == 0).all())


def test_chunk_count_comes_from_shapes_alone():
    """The wrappers size the grid and the scratch from the table's shape:
    CHUNK_KEYS key positions a chunk, in whole blocks; no tensor is
    involved and the wrapper module reads nothing back from the card."""
    assert ops.CHUNK_KEYS == 64
    assert ops.split_chunks(32, 16) == (4, 8)     # nanochat-d20's serving
    assert ops.split_chunks(16, 16) == (4, 4)
    assert ops.split_chunks(4, 4) == (16, 1)      # one chunk: direct write
    assert ops.split_chunks(3, 128) == (1, 3)     # a block past the chunk
    assert ops.split_chunks(5, 24) == (2, 3)      # bs not dividing it
    assert ops.split_chunks(0, 16) == (4, 1)
    assert ops.ring_chunks(320) == 5 and ops.ring_chunks(64) == 1
    assert ops.ring_chunks(200) == 4
    for fn in (ops.split_chunks, ops.ring_chunks):
        assert all(p.annotation is int for p in inspect.signature(
            fn, eval_str=True).parameters.values())
    src = inspect.getsource(ops)
    for sync in (".item(", ".cpu(", ".tolist(", ".numpy(", "synchronize("):
        assert sync not in src, sync


def test_cpu_wrappers_take_the_unsplit_plain_versions():
    """On CPU tensors the wrappers are the plain versions (the mirror is
    for tests only), and count no launch."""
    from repro_torch.kernels import launches, reset_launches
    q, kv, tab, start, n_tok, *_ = _inputs(5, "float32")
    reset_launches()
    got = ops.paged_verify_attention(q, *kv, tab, start, n_tok)
    assert torch.equal(got, ref.paged_verify_attention_plain(
        q, *kv, tab, start, n_tok))
    assert sum(launches.values()) == 0
