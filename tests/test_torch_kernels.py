"""The port's kernel modules against the JAX package: each plain version
(what the wrappers run for CPU tensors) against the JAX oracle AND the
Pallas kernel in interpret mode, on the same numpy inputs; f32, atol
1e-5, live rows only (rows with no attendable key are garbage in every
implementation).  Gradients (flash attention, RMSNorm), which have no
Pallas kernel, are held to ``jax.grad`` / ``jax.vjp`` of the JAX oracle.
The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them to these plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    paged_decode_attention as pallas_paged_decode,
    paged_verify_attention as pallas_paged_verify,
    reference_paged_decode_attention, reference_paged_verify_attention)
from repro.kernels.flash_attention import (
    flash_attention as pallas_flash_attention, reference_attention)
from repro.kernels.flash_attention.ref import reference_attention_fp8
from repro.kernels.fused_adamw import (fused_adamw_update as
                                       pallas_fused_adamw,
                                       reference_fused_adamw)
from repro.kernels.rmsnorm import (reference_rmsnorm,
                                   reference_rmsnorm_residual)
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_residual as pallas_rmsnorm_residual
from repro_torch.kernels import _build, launches, reset_launches
from repro_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_plain,
    paged_verify_attention, paged_verify_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_fp8_plain,
                                                 flash_attention_plain,
                                                 flash_bwd, flash_fwd)
from repro_torch.kernels.fused_adamw import (fused_adamw_plain,
                                             fused_adamw_update)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,
                                         rmsnorm_plain, rmsnorm_residual,
                                         rmsnorm_residual_plain)
from torch_cases import paged_tables, pools

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

ATOL = 1e-5


def _close(got, *wants, mask=None):
    got = np.asarray(got, np.float32)
    for want in wants:
        want = np.asarray(want, np.float32)
        if mask is not None:
            got_m, want_m = got[mask], want[mask]
        else:
            got_m, want_m = got, want
        np.testing.assert_allclose(got_m, want_m, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,d", [(8, 64), (40, 96), (7, 1280), (5, 1600),
                                 (4, 2048)])
def test_rmsnorm_plain_matches_jax_oracle_and_pallas(R, d):
    rng = np.random.default_rng(R * d)
    x = (2 * rng.standard_normal((R, d))).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (R, d)
    _close(got, reference_rmsnorm(jnp.asarray(x), jnp.asarray(s)),
           pallas_rmsnorm(jnp.asarray(x), jnp.asarray(s), interpret=True))


@pytest.mark.parametrize("shape", [(3, 8, 64), (5, 1, 96), (2, 3, 1600),
                                   (4, 1, 2048)])
def test_rmsnorm_residual_plain_matches_jax_oracle_and_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    o, h = rmsnorm_residual(torch.from_numpy(x), torch.from_numpy(r),
                            torch.from_numpy(s))
    jx, jr, js = jnp.asarray(x), jnp.asarray(r), jnp.asarray(s)
    o_ref, h_ref = reference_rmsnorm_residual(jx, jr, js)
    o_pl, h_pl = pallas_rmsnorm_residual(jx, jr, js, interpret=True)
    _close(o, o_ref, o_pl)
    _close(h, h_ref, h_pl)


def test_rmsnorm_bf16_plain_rounds_like_the_oracle():
    """bf16 in, bf16 out, statistics in f32: one rounding of the f32
    result, exactly as the JAX oracle rounds."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    s = rng.standard_normal(128).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = rmsnorm(xt, torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    want = reference_rmsnorm(jnp.asarray(xt.float().numpy(), jnp.bfloat16),
                             jnp.asarray(s))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# Paged decode / verify attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,KV,G,bs,MB,D,window", [
    (3, 2, 2, 16, 3, 32, 0),
    (4, 2, 2, 8, 8, 16, 0),        # the tiny test model's attention shape
    (2, 1, 4, 8, 4, 64, 0),
    (4, 2, 1, 16, 3, 32, 12),      # sliding window
])
def test_paged_decode_plain_matches_jax_oracle_and_pallas(S, KV, G, bs, MB,
                                                          D, window):
    rng = np.random.default_rng(S * MB + D + window)
    NB = S * MB + 2
    q = rng.standard_normal((S, KV, G, D)).astype(np.float32)
    kp, vp = pools(rng, NB, bs, KV, D)
    tables, q_pos, _, live = paged_tables(rng, S, NB, bs, MB)
    got = paged_decode_attention(*(torch.from_numpy(a) for a in
                                   (q, kp, vp, tables, q_pos)),
                                 window=window)
    assert got.shape == (S, KV, G, D)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, q_pos)]
    _close(got, reference_paged_decode_attention(*args, window=window),
           pallas_paged_decode(*args, window=window, interpret=True),
           mask=live[:, 0])


@pytest.mark.parametrize("S,T,KV,G,bs,MB,D,window", [
    (3, 4, 2, 2, 16, 3, 32, 0),
    (4, 4, 2, 2, 8, 8, 16, 0),     # spec_k=3 on the tiny test model
    (2, 6, 1, 4, 8, 4, 64, 0),
    (4, 3, 2, 1, 16, 2, 32, 12),   # sliding window
])
def test_paged_verify_plain_matches_jax_oracle_and_pallas(S, T, KV, G, bs,
                                                          MB, D, window):
    rng = np.random.default_rng(S * T + MB + D + window)
    NB = S * MB + 2
    q = rng.standard_normal((S, T, KV, G, D)).astype(np.float32)
    kp, vp = pools(rng, NB, bs, KV, D)
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    got = paged_verify_attention(*(torch.from_numpy(a) for a in
                                   (q, kp, vp, tables, start, n_tok)),
                                 window=window)
    assert got.shape == (S, T, KV, G, D)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, start, n_tok)]
    _close(got, reference_paged_verify_attention(*args, window=window),
           pallas_paged_verify(*args, window=window, interpret=True),
           mask=live)


def test_paged_verify_t1_equals_paged_decode():
    rng = np.random.default_rng(11)
    S, KV, G, bs, MB, D = 3, 2, 2, 8, 3, 32
    q = torch.from_numpy(rng.standard_normal((S, 1, KV, G, D))
                         .astype(np.float32))
    kp, vp = (torch.from_numpy(a) for a in pools(rng, 12, bs, KV, D))
    tables, q_pos, _, _ = paged_tables(rng, S, 12, bs, MB)
    tables, q_pos = torch.from_numpy(tables), torch.from_numpy(q_pos)
    one = torch.ones(S, dtype=torch.int32)
    a = paged_verify_attention(q, kp, vp, tables, q_pos, one)
    b = paged_decode_attention(q[:, 0], kp, vp, tables, q_pos)
    torch.testing.assert_close(a[:, 0][q_pos >= 0], b[q_pos >= 0],
                               atol=ATOL, rtol=0)


def test_paged_plain_ignores_unmapped_and_stale_lanes():
    """Poisoning pool rows the query may not see (beyond its position, or
    in an unmapped block) leaves its output unchanged."""
    rng = np.random.default_rng(5)
    KV, G, bs, D = 1, 2, 8, 16
    q = torch.from_numpy(rng.standard_normal((1, KV, G, D))
                         .astype(np.float32))
    kp, vp = (torch.from_numpy(a) for a in pools(rng, 4, bs, KV, D))
    tables = torch.tensor([[-1, 2, 3]], dtype=torch.int32)
    q_pos = torch.tensor([12], dtype=torch.int32)     # block 1, offset 4
    before = paged_decode_attention(q, kp, vp, tables, q_pos)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[2, 5:], vp2[2, 5:] = 1e4, -1e4                # beyond position 12
    kp2[3], vp2[3] = 1e4, -1e4                        # block past the query
    kp2[0], vp2[0] = 1e4, -1e4                        # what -1 would read
    after = paged_decode_attention(q, kp2, vp2, tables, q_pos)
    torch.testing.assert_close(before, after, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# RMSNorm backward (no Pallas kernel: held to jax.vjp of the oracles)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 64), (3, 7, 96), (5, 1280)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_bwd_plain_matches_jax_vjp(shape, residual):
    """dx (= d residual) and dscale against jax.vjp of the JAX oracle;
    f32, atol 1e-5 (dscale sums over rows: rtol 1e-5 too)."""
    rng = np.random.default_rng(sum(shape) + residual)
    x, r, dy, dh = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    s = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    if residual:
        _, vjp = jax.vjp(reference_rmsnorm_residual, *(jnp.asarray(a)
                                                       for a in (x, r, s)))
        jdx, jdr, jds = vjp((jnp.asarray(dy), jnp.asarray(dh)))
        np.testing.assert_array_equal(np.asarray(jdx), np.asarray(jdr))
        dx, ds = rmsnorm_bwd(t(dy), t(x), t(s), residual=t(r), dh=t(dh))
    else:
        _, vjp = jax.vjp(reference_rmsnorm, jnp.asarray(x), jnp.asarray(s))
        jdx, jds = vjp(jnp.asarray(dy))
        dx, ds = rmsnorm_bwd(t(dy), t(x), t(s))
    _close(dx, jdx)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=1e-5,
                               rtol=1e-5)


def test_rmsnorm_autograd_runs_the_plain_backward_on_cpu():
    """The differentiable wrappers' gradients on the CPU are the plain
    backward's, and equal autograd through the plain forward."""
    rng = np.random.default_rng(1)
    x, r = (torch.from_numpy(rng.standard_normal((4, 3, 32))
                             .astype(np.float32)).requires_grad_()
            for _ in range(2))
    s = torch.from_numpy((1 + 0.1 * rng.standard_normal(32))
                         .astype(np.float32)).requires_grad_()
    dy, dh = torch.randn(4, 3, 32), torch.randn(4, 3, 32)
    got = torch.autograd.grad(rmsnorm_residual(x, r, s), (x, r, s),
                              (dy, dh))
    want = torch.autograd.grad(rmsnorm_residual_plain(x, r, s), (x, r, s),
                               (dy, dh))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    got = torch.autograd.grad(rmsnorm(x, s), (x, s), dy)
    want = torch.autograd.grad(rmsnorm_plain(x, s), (x, s), dy)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Flash attention (layout (B, S, H, D); the JAX kernel's is (B, H, S, D))
# ---------------------------------------------------------------------------

def _bhsd(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


def _qkv(rng, B, S, H, KV, D):
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 32, 4, 2, 16, None),       # GQA, G = 2, four 8-row tiles
    (1, 32, 2, 2, 32, 8),          # sliding window: tiles skipped
    (2, 24, 4, 1, 16, None),       # G = 4
])
def test_flash_plain_matches_jax_oracle_and_pallas(B, S, H, KV, D, window):
    rng = np.random.default_rng(S + H + D)
    q, k, v = _qkv(rng, B, S, H, KV, D)
    o, lse = flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                       window=window)
    assert o.shape == (B, S, H, D) and lse.shape == (B, H, S)
    jq, jk, jv = _bhsd(q), _bhsd(k), _bhsd(v)
    want = [np.asarray(reference_attention(jq, jk, jv, window=window)),
            np.asarray(pallas_flash_attention(jq, jk, jv, window=window,
                                              bq=8, bk=8, interpret=True))]
    _close(o.numpy().transpose(0, 2, 1, 3), *want)


@pytest.mark.parametrize("S,window", [(21, None), (37, 5), (1, None)])
def test_flash_plain_non_tile_lengths_match_jax_oracle(S, window):
    """S that is no multiple of any tile (the Pallas kernel asserts
    divisibility; the oracle takes any S), with and without a window."""
    rng = np.random.default_rng(S)
    q, k, v = _qkv(rng, 2, S, 4, 2, 16)
    o, _ = flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                     window=window)
    want = reference_attention(_bhsd(q), _bhsd(k), _bhsd(v), window=window)
    _close(o.numpy().transpose(0, 2, 1, 3), want)


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 32, 4, 2, 16, None),
    (1, 29, 4, 1, 16, 6),          # G = 4, window, S not a tile multiple
    (2, 16, 2, 2, 32, None),
])
def test_flash_bwd_plain_matches_jax_grad(B, S, H, KV, D, window):
    """dq, dk, dv from the saved (o, lse) against jax.vjp of the JAX
    oracle (the Pallas kernel has no VJP); f32, atol 1e-5 (the sums run
    over G * S terms)."""
    rng = np.random.default_rng(B * S + H + D)
    q, k, v = _qkv(rng, B, S, H, KV, D)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: reference_attention(a, b, c,
                                                         window=window),
                     _bhsd(q), _bhsd(k), _bhsd(v))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(_bhsd(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_fwd(tq, tk, tv, window=window)
    for got, w in zip(flash_bwd(tq, tk, tv, o, lse, tdo, window=window),
                      want):
        _close(got, w)
    # the autograd.Function (plain forward + plain backward on the CPU)
    leaves = [a.clone().requires_grad_() for a in (tq, tk, tv)]
    grads = torch.autograd.grad(flash_attention(*leaves, window=window),
                                leaves, tdo)
    for got, w in zip(grads, want):
        _close(got, w)


def test_flash_bwd_plain_equals_autograd_through_the_plain_forward():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(rng, 2, 19, 4, 2, 16))
    do = torch.randn(2, 19, 4, 16)
    o, lse = flash_attention_plain(q, k, v, True, 7)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    o.detach(), lse, do, True, 7)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("H", [4, 2])
def test_flash_fp8_plain_matches_jax_oracle_and_pallas(causal, window, H):
    """The ``fp8=True`` forward (QK^T on per-row fp8_e4m3 codes) at the
    JAX package's own test cases ((1, H, 256, 64), KV 2): the plain
    version against ``reference_attention_fp8`` and the interpret-mode
    ``flash_attention(fp8=True)`` within 2e-5, and more than 1e-3 away
    from the exact attention (the narrow path is live)."""
    ks = jax.random.split(jax.random.key(42), 3)
    jq = jax.random.normal(ks[0], (1, H, 256, 64), jnp.float32)
    jk = jax.random.normal(ks[1], (1, 2, 256, 64), jnp.float32)
    jv = jax.random.normal(ks[2], (1, 2, 256, 64), jnp.float32)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 2, 1, 3))) for a in (jq, jk, jv))
    o, lse = flash_fwd(q, k, v, causal=causal, window=window, fp8=True)
    assert o.shape == q.shape and lse.shape == (1, H, 256)
    got = o.numpy().transpose(0, 2, 1, 3)
    kw = dict(causal=causal, window=window)
    for want in (reference_attention_fp8(jq, jk, jv, **kw),
                 pallas_flash_attention(jq, jk, jv, fp8=True,
                                        interpret=True, **kw)):
        assert np.abs(got - np.asarray(want)).max() < 2e-5
    exact = np.asarray(reference_attention(jq, jk, jv, **kw))
    assert np.abs(got - exact).max() > 1e-3
    o2, lse2 = flash_attention_fp8_plain(q, k, v, causal, window)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_fp8_plain_bf16_rounds_like_the_oracle():
    """bf16 inputs: the dequantized rows are rounded back to bf16 before
    the exact attention, as ``reference_attention_fp8`` does."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 64, 4, 2, 32)
    jq, jk, jv = (_bhsd(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    o, _ = flash_fwd(tq, tk, tv, window=16, fp8=True)
    assert o.dtype == torch.bfloat16
    want = np.asarray(reference_attention_fp8(jq, jk, jv, window=16)
                      .astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o.float().numpy(), want, atol=1e-2, rtol=0)


def test_flash_fp8_is_forward_only():
    """The JAX kernel's fp8 path has no backward: the port's backward and
    the autograd ``flash_attention`` refuse ``fp8=True``."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 16, 2, 2, 16))
    o, lse = flash_fwd(q, k, v, fp8=True)
    with pytest.raises(ValueError, match="forward only"):
        flash_bwd(q, k, v, o, lse, o, fp8=True)
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(q.requires_grad_(), k, v, fp8=True)


# ---------------------------------------------------------------------------
# Fused AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((7, 13), np.float32),
                                         ((300,), np.float32),
                                         ((4, 129), "bfloat16")])
def test_fused_adamw_plain_matches_jax_oracle_and_pallas(shape, dtype):
    """Any leaf length (no LANE padding); p and g in f32 or bf16.  The
    plain version runs the oracle's operations in its order: agreement to
    1-2 ulp (rtol 1e-6), as the JAX package states for its own kernel;
    where the two terms of a sum nearly cancel (b1 m + (1-b1) g, or the
    decay against the step), an ulp of the O(0.1) terms is the absolute
    floor (atol 1e-8)."""
    rng = np.random.default_rng(int(np.prod(shape)))
    p, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = rng.random(shape).astype(np.float32)
    lr, bc1, bc2 = np.float32(3e-3), np.float32(1 - 0.9 ** 3), \
        np.float32(1 - 0.95 ** 3)
    kw = dict(b1=0.9, b2=0.95, eps=1e-10, wd=0.1)
    tp, tg = torch.from_numpy(p), torch.from_numpy(g)
    jp, jg = jnp.asarray(p), jnp.asarray(g)
    if dtype == "bfloat16":
        tp, tg = tp.bfloat16(), tg.bfloat16()
        jp = jnp.asarray(tp.float().numpy(), jnp.bfloat16)
        jg = jnp.asarray(tg.float().numpy(), jnp.bfloat16)
    got = fused_adamw_update(tp, tg, torch.from_numpy(m), torch.from_numpy(v),
                             *(torch.tensor(x) for x in (lr, bc1, bc2)),
                             **kw)
    jargs = (jp, jg, jnp.asarray(m), jnp.asarray(v), lr, bc1, bc2)
    for want in (reference_fused_adamw(*jargs, **kw),
                 pallas_fused_adamw(*jargs, interpret=True, **kw)):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.shape == shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-8)
    torch.testing.assert_close(
        got, fused_adamw_plain(tp, tg, torch.from_numpy(m),
                               torch.from_numpy(v),
                               *(torch.tensor(x) for x in (lr, bc1, bc2)),
                               **kw), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors take the plain version; no silent fallback
# ---------------------------------------------------------------------------

def test_cpu_calls_take_plain_versions_and_count_no_launch():
    reset_launches()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    s = torch.ones(64)
    torch.testing.assert_close(rmsnorm(x, s), rmsnorm_plain(x, s))
    o, h = rmsnorm_residual(x, x, s)
    o2, h2 = rmsnorm_residual_plain(x, x, s)
    torch.testing.assert_close((o, h), (o2, h2))
    q = torch.zeros((2, 1, 1, 16))
    kp = torch.zeros((2, 4, 1, 16))
    tab = torch.tensor([[0], [1]], dtype=torch.int32)
    pos = torch.tensor([3, -1], dtype=torch.int32)
    torch.testing.assert_close(
        paged_decode_attention(q, kp, kp, tab, pos),
        paged_decode_attention_plain(q, kp, kp, tab, pos))
    torch.testing.assert_close(
        paged_verify_attention(q[:, None], kp, kp, tab, pos,
                               torch.ones(2, dtype=torch.int32)),
        paged_verify_attention_plain(q[:, None], kp, kp, tab, pos,
                                     torch.ones(2, dtype=torch.int32)))
    assert sum(launches.values()) == 0


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rmsnorm(x, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rmsnorm_residual(x, x, torch.empty(8, device="meta"))
    q = torch.empty((1, 1, 1, 16), device="meta")
    kp = torch.empty((1, 4, 1, 16), device="meta")
    tab = torch.empty((1, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        paged_decode_attention(q, kp, kp, tab, pos)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        paged_verify_attention(q[:, None], kp, kp, tab, pos, pos)


def test_training_wrappers_refuse_devices_they_have_no_kernel_for():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_bwd(q, q, q, q, torch.empty((1, 2, 8), device="meta"), q)
    p = torch.empty(10, device="meta")
    one = torch.ones((), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_adamw_update(p, p, p, p, one, one, one, b1=0.9, b2=0.95,
                           eps=1e-10, wd=0.0)
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rmsnorm_bwd(x, x, torch.empty(8, device="meta"))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No toolkit, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["rmsnorm"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_attention", {})


def test_training_wrappers_on_cpu_count_no_launch():
    reset_launches()
    q = torch.randn(1, 8, 2, 16)
    o = flash_attention(q.requires_grad_(), q, q)
    o.sum().backward()
    fused_adamw_update(*(torch.ones(5) for _ in range(4)),
                       *(torch.tensor(0.5) for _ in range(3)), b1=0.9,
                       b2=0.95, eps=1e-10, wd=0.0)
    x = torch.ones((2, 8), requires_grad=True)
    rmsnorm(x, torch.ones(8)).sum().backward()
    assert sum(launches.values()) == 0


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edit to split_combine.cuh renames (so rebuilds) both libraries
    that include it, and no other."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("paged_attention", "ring_attention", "rmsnorm")
    before = {n: _build._lib_path(n) for n in names}
    with open(tmp_path / "split_combine.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in names}
    assert after["paged_attention"] != before["paged_attention"]
    assert after["ring_attention"] != before["ring_attention"]
    assert after["rmsnorm"] == before["rmsnorm"]
    for name, headers in _build.HEADERS.items():
        assert name in _build.SOURCES
        assert all((_build.CSRC / h).is_file() for h in headers)
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert all(f'#include "{h}"' in src for h in headers)


def test_build_names_libraries_by_source_hash():
    a, b = _build._lib_path("rmsnorm"), _build._lib_path("paged_attention")
    assert a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("rmsnorm-") and a.suffix == ".so"
    assert a != b and _build._lib_path("rmsnorm") == a
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
