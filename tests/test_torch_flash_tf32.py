"""The split-TF32 arithmetic of the flash attention kernels, on the CPU.

The CUDA kernels take every product on the tensor cores with TF32 inputs:
each f32 operand x is split as hi = TF32(x) (``cvt.rna.tf32.f32``: round
to nearest, ties away from zero) and lo = TF32(x - hi), and a.b is taken
as hi_a.lo_b + lo_a.hi_b + hi_a.hi_b.  These tests hold that design to the
JAX package before a card does: the rounding bit for bit on known
patterns, the split's error, the operands that need no lo part (bf16
values, e4m3 codes), and attention with every product so taken against
``reference_attention`` and ``jax.grad`` of it within the f32 tolerances
of the card's gates, where one plain TF32 product is not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import reference_attention
from repro_torch.kernels.flash_attention.ref import split_tf32, tf32_round

torch.set_num_threads(1)

O_TOL = (1e-5, 1e-4)        # (atol, rtol): chip_smoke's f32 forward
GRAD_TOL = (1e-4, 1e-4)     # chip_smoke's f32 backward


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


def _bits(x):
    return x.numpy().view(np.uint32).tolist()


# (input bits, cvt.rna.tf32.f32 bits)
RNA_CASES = [
    (0x3F801000, 0x3F802000),   # a tie rounds away from zero (RNE: down)
    (0xBF801000, 0xBF802000),   # ... for either sign
    (0x3F800FFF, 0x3F800000),   # below half a TF32 ulp
    (0x3F803000, 0x3F804000),   # a tie between two TF32 values
    (0x3F801001, 0x3F802000),   # above half
    (0x3FFFFFFF, 0x40000000),   # the carry moves into the exponent
    (0x00001000, 0x00002000),   # subnormal tie
    (0x00000FFF, 0x00000000),
    (0x7F7FFFFF, 0x7F800000),   # the largest finite f32 rounds to inf
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),   # -0
]


def test_tf32_round_matches_cvt_rna_on_known_bit_patterns():
    src, want = zip(*RNA_CASES)
    assert _bits(tf32_round(_f32(src))) == list(want)
    nan = tf32_round(_f32([0x7FC00000]))
    assert torch.isnan(nan).all()


def test_split_is_exact_in_f32_and_within_two_to_minus_22():
    """hi keeps 11 significant bits and x - hi is exact in f32.  lo keeps
    11 of the residual's up to 13 bits, so hi + lo is x to within
    2^-22 |x| (not always exactly x), and exactly x where the residual
    fits in TF32."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000)
         * 10.0 ** rng.uniform(-20, 20, 200_000)).astype(np.float32)
    hi, lo = split_tf32(torch.from_numpy(x))
    x64, hi64, lo64 = (np.asarray(t, np.float64) for t in (x, hi, lo))
    np.testing.assert_array_equal(_bits(hi), _bits(tf32_round(torch.from_numpy(x))))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    # the residual is exact in f32
    np.testing.assert_array_equal(x64 - hi64,
                                  (x - hi.numpy()).astype(np.float64))
    assert (np.abs(x64 - (hi64 + lo64)) <= 2.0 ** -22 * np.abs(x64)).all()
    fits = (((x - hi.numpy()).view(np.uint32) & 0x1FFF) == 0)
    assert fits.any() and not fits.all()
    np.testing.assert_array_equal(hi64[fits] + lo64[fits], x64[fits])


def test_bf16_values_and_e4m3_codes_need_no_lo_part():
    """bf16 values (8 significant bits) and e4m3 codes (4) are TF32
    values: the kernels take one product where both operands are such,
    two where one is."""
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)
                         * 10.0 ** rng.uniform(-30, 30, 100_000).astype(
                             np.float32)).to(torch.bfloat16).float()
    codes = torch.arange(256, dtype=torch.uint8).view(
        torch.float8_e4m3fn).float()
    codes = codes[~torch.isnan(codes)]
    for x in (b, codes):
        hi, lo = split_tf32(x)
        assert torch.equal(hi, x)
        assert not lo.any()


def _mm(a, b, terms):
    """a @ b (f32) with TF32 products: 3 = the kernels' split, 1 = plain
    TF32 (one product on rounded operands).  A product of two TF32 values
    is exact in f32; the sums are f32."""
    if terms == 1:
        return tf32_round(a) @ tf32_round(b)
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (ah @ bl + al @ bh) + ah @ bh


def _attention(q, k, v, do, window, terms):
    """The kernels' arithmetic (causal, q/do (B, H, S, D), k/v (B, KV, S,
    D), KV = H) with every product of the forward and the backward taken
    by ``_mm``: o, lse and (dq, dk, dv)."""
    S, D = q.shape[-2], q.shape[-1]
    scale = 1.0 / np.sqrt(D)
    pos = torch.arange(S)
    ok = pos[:, None] >= pos[None, :]
    if window:
        ok &= pos[:, None] - pos[None, :] < window
    s = _mm(q, k.transpose(-1, -2), terms) * scale
    s = torch.where(ok, s, torch.tensor(float("-inf")))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _mm(p, v, terms) / l
    lse = m + torch.log(l)
    pn = torch.exp(s - lse)                    # masked: exp(-inf) = 0
    delta = (do * o).sum(-1, keepdim=True)
    ds = pn * (_mm(do, v.transpose(-1, -2), terms) - delta)
    dq = _mm(ds, k, terms) * scale
    dk = _mm(ds.transpose(-1, -2), q, terms) * scale
    dv = _mm(pn.transpose(-1, -2), do, terms)
    return o, lse[..., 0], (dq, dk, dv)


def _case(window):
    rng = np.random.default_rng(18 + (window or 0))
    B, H, S, D = 1, 2, 1024, 128
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    ref = lambda a, b, c: reference_attention(a, b, c, causal=True,
                                              window=window)
    o_ref, vjp = jax.vjp(ref, jq, jk, jv)
    grads_ref = vjp(jdo)
    # lse in f64 from the exact scores
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(D)
    pos = np.arange(S)
    ok = pos[:, None] >= pos[None, :]
    if window:
        ok &= pos[:, None] - pos[None, :] < window
    s = np.where(ok, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    lse_ref = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    got = [torch.from_numpy(a) for a in (q, k, v, do)]
    return got, np.asarray(o_ref), lse_ref, [np.asarray(g) for g in grads_ref]


def _within(got, want, tol):
    atol, rtol = tol
    return bool(np.all(np.abs(np.asarray(got, np.float64) - want)
                       <= atol + rtol * np.abs(want)))


@pytest.mark.parametrize("window", [None, 256])
def test_split_tf32_attention_within_the_f32_gates_and_plain_tf32_outside(
        window):
    """(c) every product as the 3-term split: o within 1e-5 + 1e-4 of
    ``reference_attention``, lse within 1e-4 + 1e-5 |lse| of the exact
    one, dq/dk/dv within 1e-4 + 1e-4 of ``jax.vjp`` of it; (d) one plain
    TF32 product instead falls outside, so the gates tell them apart."""
    (q, k, v, do), o_ref, lse_ref, grads_ref = _case(window)
    o, lse, grads = _attention(q, k, v, do, window, terms=3)
    assert _within(o, o_ref, O_TOL)
    assert np.all(np.abs(lse.numpy() - lse_ref)
                  <= 1e-4 + 1e-5 * np.abs(lse_ref).max())
    for g, w in zip(grads, grads_ref):
        assert _within(g, w, GRAD_TOL)
    o1, _, grads1 = _attention(q, k, v, do, window, terms=1)
    assert not _within(o1, o_ref, O_TOL)
    assert not all(_within(g, w, GRAD_TOL) for g, w in zip(grads1, grads_ref))
