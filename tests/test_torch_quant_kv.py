"""Quantized KV pools (int8, fp8, fp8_e5m2), a bf16 pool under f32
compute, and the fp8 QK^T (``fp8_matmul``) in the port, against the JAX
package on the same numpy inputs and parameters:

* ``quantize_axis`` equals ``reference_quantize_axis`` bit for bit;
* the plain dequant and fp8 attention versions equal the JAX oracles and
  the Pallas kernels in interpret mode (f32, atol 1e-5, live rows);
* the paged steps on a quantized pool give the JAX steps' logits (1e-4),
  the same payload bytes and the same scales (1e-6);
* the engine's greedy tokens equal the JAX engine's; inside the port,
  speculation and prefix sharing stay bit-exact on quantized pools, the
  copy-on-write fork copies the scale planes, and a byte-budget churn
  run equals each request served alone;
* training with ``fp8_matmul`` computes what the JAX package computes
  (its training attention has no fp8 path)."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.kernels.decode_attention import (
    paged_decode_attention as pallas_paged_decode,
    paged_decode_attention_dequant as pallas_paged_decode_dequant,
    paged_verify_attention as pallas_paged_verify,
    paged_verify_attention_dequant as pallas_paged_verify_dequant,
    reference_paged_decode_attention,
    reference_paged_decode_attention_dequant,
    reference_paged_decode_attention_fp8,
    reference_paged_verify_attention_dequant,
    reference_paged_verify_attention_fp8)
from repro.kernels.quantize import reference_quantize_axis
from repro.models.transformer import build_model
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.models.transformer import paged_block_bytes as jax_block_bytes
from repro.serving import Engine as JaxEngine
from repro_torch import Engine, Request
from repro_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_dequant,
    paged_verify_attention, paged_verify_attention_dequant)
from repro_torch.kernels.quantize import QMAX, quantize_axis
from repro_torch.launch import serve
from repro_torch.models.attention import serving_matmul
from repro_torch.models.layers import token_matmul
from repro_torch.models import (decode_step_paged, init_paged_cache,
                                lm_loss, paged_block_bytes,
                                verify_step_paged)
from repro_torch.serving.scheduler import Scheduler
from torch_cases import paged_tables, pools
from torch_parity import RAGGED, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

ATOL = 1e-5
TARGETS = ["int8", "fp8_e4m3", "fp8_e5m2"]
KV_DTYPES = ["int8", "fp8", "fp8_e5m2"]        # kv_cache_dtype spellings
TPL = [7, 3, 9, 1, 5, 2, 8, 4] * 3      # 24-token template = 3 blocks @ bs=8
SHARED = [TPL + [50 + i] * (i % 4 + 1) for i in range(6)]


def _close(got, *wants, mask):
    got = np.asarray(got, np.float32)[mask]
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32)[mask],
                                   atol=ATOL, rtol=0)


def _bytes(x) -> np.ndarray:
    """A 1-byte payload (torch or jax) as its raw bytes."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# ---------------------------------------------------------------------------
# quantize_axis: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("seed", range(3))
def test_quantize_axis_matches_reference_bit_for_bit(target, seed):
    """Payload bytes and scales equal over 14 decades of magnitude, with
    all-zero rows (scale 1e-12 / QMAX), rows holding ±QMAX, ties of the
    int8 rounding (x.5 after scaling) and subnormal-sized values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((48, 3, 32))
         * 10.0 ** rng.uniform(-8, 6, (48, 3, 1))).astype(np.float32)
    qmax = QMAX[target]
    x[0] = 0.0
    x[1, 0, 0], x[1, 1, :] = qmax, -qmax
    x[2, :, :] = np.float32(1e-30)
    x[3, 0, :] = np.arange(32, dtype=np.float32) - 15.5       # .5 ties
    x[3, 0, 0] = 127.0
    q, s = quantize_axis(torch.from_numpy(x), axis=-1, dtype=target)
    rq, rs = reference_quantize_axis(jnp.asarray(x), axis=-1, dtype=target)
    np.testing.assert_array_equal(_bytes(q), _bytes(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert (s[0] == np.float32(1e-12) / np.float32(qmax)).all()
    # another axis and an empty slice
    q0, s0 = quantize_axis(torch.from_numpy(x), axis=0, dtype=target)
    rq0, rs0 = reference_quantize_axis(jnp.asarray(x), axis=0, dtype=target)
    np.testing.assert_array_equal(_bytes(q0), _bytes(rq0))
    np.testing.assert_array_equal(s0.numpy(), np.asarray(rs0))
    qe, se = quantize_axis(torch.zeros((0, 3, 4)), dtype=target)
    assert qe.shape == (0, 3, 4) and se.shape == (0, 3, 1)


# ---------------------------------------------------------------------------
# Plain dequant and fp8 attention vs the JAX oracles and Pallas (interpret)
# ---------------------------------------------------------------------------

def _quantized_pools(rng, NB, bs, KV, D, target):
    """Random K/V quantized per (token, head) with the JAX oracle: numpy
    (k, v, k_scale (NB, bs, KV), v_scale)."""
    out = []
    for p in pools(rng, NB, bs, KV, D):
        q, s = reference_quantize_axis(jnp.asarray(p), axis=-1, dtype=target)
        out.append((q, s[..., 0]))
    (kq, ks), (vq, vs) = out
    return kq, vq, np.asarray(ks), np.asarray(vs)


def _to_torch(x) -> torch.Tensor:
    """numpy / jax array -> torch, fp8 payloads through their bytes."""
    a = np.asarray(x)
    names = {"float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}
    if a.dtype.name in names:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            names[a.dtype.name])
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("T,S,KV,G,bs,MB,D,window", [
    (1, 4, 2, 2, 8, 8, 16, 0),     # the tiny test model's decode shape
    (1, 3, 1, 4, 16, 3, 64, 12),   # sliding window
    (4, 4, 2, 2, 8, 8, 16, 0),     # spec_k=3 on the tiny test model
    (3, 3, 2, 1, 16, 3, 32, 12),
])
def test_dequant_plain_matches_jax_oracle_and_pallas(target, T, S, KV, G, bs,
                                                     MB, D, window):
    rng = np.random.default_rng(T * 100 + S * MB + D + window)
    NB = S * MB + 2
    shape = (S, KV, G, D) if T == 1 else (S, T, KV, G, D)
    q = rng.standard_normal(shape).astype(np.float32)
    kq, vq, ks, vs = _quantized_pools(rng, NB, bs, KV, D, target)
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    pos = (start,) if T == 1 else (start, n_tok)
    got = (paged_decode_attention_dequant if T == 1 else
           paged_verify_attention_dequant)(
        *(_to_torch(a) for a in (q, kq, vq, ks, vs, tables) + pos),
        window=window)
    assert got.shape == shape and got.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, tables) + pos]
    if T == 1:
        want = reference_paged_decode_attention_dequant(*jargs,
                                                        window=window)
        pallas = pallas_paged_decode_dequant(*jargs, window=window,
                                             interpret=True)
        mask = live[:, 0]
    else:
        want = reference_paged_verify_attention_dequant(*jargs,
                                                        window=window)
        pallas = pallas_paged_verify_dequant(*jargs, window=window,
                                             interpret=True)
        mask = live
    _close(got, want, pallas, mask=mask)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,KV,G,bs,MB,D,window", [
    (1, 4, 2, 2, 8, 8, 16, 0),
    (1, 3, 1, 4, 16, 3, 64, 12),
    (4, 4, 2, 2, 8, 8, 16, 0),
    (3, 3, 2, 1, 16, 3, 32, 12),
])
def test_fp8_plain_matches_jax_oracle_and_pallas(pool_dtype, T, S, KV, G, bs,
                                                 MB, D, window):
    """fp8 QK^T on a plain pool; a bf16 pool under f32 queries is read
    as the JAX package reads it, cast up to f32 first (exact)."""
    rng = np.random.default_rng(T * 10 + S * MB + D + window)
    NB = S * MB + 2
    shape = (S, KV, G, D) if T == 1 else (S, T, KV, G, D)
    q = rng.standard_normal(shape).astype(np.float32)
    kp, vp = (torch.from_numpy(p).to(getattr(torch, pool_dtype))
              for p in pools(rng, NB, bs, KV, D))
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    pos = (start,) if T == 1 else (start, n_tok)
    targs = [torch.from_numpy(a) for a in (tables,) + pos]
    jargs = [jnp.asarray(a) for a in (q, kp.float().numpy(),
                                      vp.float().numpy(), tables) + pos]
    if T == 1:
        got = paged_decode_attention(torch.from_numpy(q), kp, vp, *targs,
                                     window=window, fp8=True)
        want = reference_paged_decode_attention_fp8(*jargs, window=window)
        pallas = pallas_paged_decode(*jargs, window=window, interpret=True,
                                     fp8=True)
        plain = reference_paged_decode_attention(*jargs, window=window)
        mask = live[:, 0]
    else:
        got = paged_verify_attention(torch.from_numpy(q), kp, vp, *targs,
                                     window=window, fp8=True)
        want = reference_paged_verify_attention_fp8(*jargs, window=window)
        pallas = pallas_paged_verify(*jargs, window=window, interpret=True,
                                     fp8=True)
        plain = None
        mask = live
    _close(got, want, pallas, mask=mask)
    if plain is not None:     # the fp8 path is really another computation
        assert np.abs(np.asarray(got)[mask]
                      - np.asarray(plain)[mask]).max() > 1e-4


# ---------------------------------------------------------------------------
# Paged steps on a quantized pool vs the JAX steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_params():
    cfg = tiny_cfg("dense")
    params, _ = jax_init_params(cfg, jax.random.key(0))
    return params, port_params(cfg, params)


def _random_quantized_pool(rng, cfg, NB, bs):
    """A numpy pool for the JAX model: quantized random K/V per layer."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    target = {"int8": "int8", "fp8": "fp8_e4m3",
              "fp8_e5m2": "fp8_e5m2"}[cfg.kv_cache_dtype]
    pool = {}
    for name in ("k", "v"):
        x = rng.standard_normal((L, NB, bs, KV, hd)).astype(np.float32)
        q, s = reference_quantize_axis(jnp.asarray(x), axis=-1, dtype=target)
        pool[name], pool[f"{name}_scale"] = q, s[..., 0]
    return pool


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("T,seed", [(1, 0), (4, 1)])
def test_paged_steps_on_quantized_pool_match_jax(tiny_params, kv, T, seed):
    params, tparams = tiny_params
    cfg = tiny_cfg("dense", kv_cache_dtype=kv)
    m = build_model(cfg)
    rng = np.random.default_rng(seed)
    S, bs, MB = 5, 8, 4
    NB = S * MB + 3
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    pool = _random_quantized_pool(rng, cfg, NB, bs)
    tokens = rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32)
    t = np.arange(T)[None, :]
    pos = np.where((start[:, None] >= 0) & (t < n_tok[:, None]),
                   start[:, None] + t, -1).astype(np.int32)
    tpool = {k: _to_torch(v) for k, v in pool.items()}
    jpool = dict(pool)
    if T == 1:
        want, jpool = m.decode_step_paged(params, jpool, {
            "token": jnp.asarray(tokens), "position": jnp.asarray(pos[:, 0]),
            "block_table": jnp.asarray(tables)})
        got, tpool2 = decode_step_paged(tparams, tpool, {
            "token": torch.from_numpy(tokens),
            "position": torch.from_numpy(pos[:, 0].copy()),
            "block_table": torch.from_numpy(tables)}, port_cfg(cfg))
    else:
        want, jpool = m.verify_step_paged(params, jpool, {
            "tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
            "block_table": jnp.asarray(tables)})
        got, tpool2 = verify_step_paged(tparams, tpool, {
            "tokens": torch.from_numpy(tokens),
            "positions": torch.from_numpy(pos),
            "block_table": torch.from_numpy(tables)}, port_cfg(cfg))
    assert tpool2 is tpool and set(tpool) == set(jpool)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=0)
    for k in ("k", "v"):
        assert tpool[k].dtype == init_paged_cache(port_cfg(cfg), 1,
                                                  bs)[k].dtype
        np.testing.assert_array_equal(_bytes(tpool[k]), _bytes(jpool[k]))
        np.testing.assert_allclose(tpool[f"{k}_scale"].numpy(),
                                   np.asarray(jpool[f"{k}_scale"]),
                                   atol=1e-6, rtol=0)
    # the step wrote something: every live token's scale row is fresh
    assert not np.array_equal(tpool["k_scale"].numpy(), pool["k_scale"])


def test_bf16_pool_under_f32_compute_matches_jax(tiny_params):
    """kv_cache_dtype="bf16" with f32 compute: the pool stores bf16, the
    kernels read it in f32 (exact), as the JAX package does."""
    params, tparams = tiny_params
    cfg = tiny_cfg("dense", kv_cache_dtype="bf16")
    m = build_model(cfg)
    rng = np.random.default_rng(3)
    S, bs, MB, T = 5, 8, 4, 4
    NB = S * MB + 3
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    kp, vp = pools(rng, NB, bs, 2, 16)
    tpool = init_paged_cache(port_cfg(cfg), NB, bs)
    assert tpool["k"].dtype == torch.bfloat16 and set(tpool) == {"k", "v"}
    for name, p in (("k", kp), ("v", vp)):
        tpool[name][:] = torch.from_numpy(p)
    jpool = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
             for k, v in tpool.items()}
    tokens = rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32)
    t = np.arange(T)[None, :]
    pos = np.where((start[:, None] >= 0) & (t < n_tok[:, None]),
                   start[:, None] + t, -1).astype(np.int32)
    want, jpool = m.verify_step_paged(params, jpool, {
        "tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
        "block_table": jnp.asarray(tables)})
    got, _ = verify_step_paged(tparams, tpool, {
        "tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(pos),
        "block_table": torch.from_numpy(tables)}, port_cfg(cfg))
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool[k].float().numpy(),
                                   np.asarray(jpool[k], np.float32),
                                   atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("kw,per_token", [
    ({}, False), ({"kv_cache_dtype": "bf16"}, False),
    ({"kv_cache_dtype": "int8"}, True), ({"kv_cache_dtype": "fp8"}, True),
    ({"fp8_matmul": True}, True)])
def test_serving_matmul_runs_token_columns_where_attention_quantizes(
        kw, per_token):
    """Where K/V or Q/K are quantized, serving GEMMs run per token column,
    each the (S, d) GEMM of a decode step, bit for bit."""
    assert (serving_matmul(port_cfg(tiny_cfg("dense", **kw)))
            is token_matmul) == per_token
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((4, 5, 16), generator=g), torch.randn((16, 8),
                                                            generator=g)
    got = token_matmul(x, w)
    assert got.shape == (4, 5, 8) and got.is_contiguous()
    for t in range(5):
        assert torch.equal(got[:, t], x[:, t].contiguous() @ w)
    assert torch.equal(token_matmul(x[:, :1], w), x[:, :1] @ w)


# ---------------------------------------------------------------------------
# Engine parity with the JAX engine
# ---------------------------------------------------------------------------

def _pair(tiny_params, cfg_kw, jax_kw=None, **kw):
    params, tparams = tiny_params
    cfg = tiny_cfg("dense", **cfg_kw)
    kw = dict(dict(num_slots=4, max_len=64, block_size=8), **kw)
    return (JaxEngine(build_model(cfg), params, **dict(kw, **(jax_kw or {}))),
            Engine(port_cfg(cfg), tparams, device="cpu", **kw))


@pytest.mark.parametrize("kv", KV_DTYPES + ["bf16"])
@pytest.mark.parametrize("spec_k", [0, 3])
def test_greedy_tokens_equal_jax_engine_on_quantized_pools(tiny_params, kv,
                                                           spec_k):
    jax_eng, eng = _pair(tiny_params, dict(kv_cache_dtype=kv), spec_k=spec_k)
    want = jax_eng.generate_ids(RAGGED, max_new=13)
    got = eng.generate_ids(RAGGED, max_new=13)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_fp8_matmul_greedy_tokens_equal_jax_pallas_engine(tiny_params,
                                                          spec_k):
    """fp8_matmul reaches only the JAX package's Pallas kernels (its jnp
    path ignores the flag), so the reference here is the JAX engine with
    ``attn_impl="pallas"`` in interpret mode."""
    jax_eng, eng = _pair(tiny_params, dict(fp8_matmul=True),
                         dict(attn_impl="pallas"), spec_k=spec_k)
    want = jax_eng.generate_ids(RAGGED, max_new=13)
    got = eng.generate_ids(RAGGED, max_new=13)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv", ["", "bf16", "f32", "float32", "int8", "fp8",
                                "fp8_e4m3", "fp8_e5m2"])
def test_block_bytes_and_kv_report_match_jax_engine(tiny_params, kv):
    jax_eng, eng = _pair(tiny_params, dict(kv_cache_dtype=kv),
                         pool_bytes=40_000)
    cfg = tiny_cfg("dense", kv_cache_dtype=kv)
    assert paged_block_bytes(port_cfg(cfg), 8) == jax_block_bytes(cfg, 8)
    assert eng.kv_report() == jax_eng.kv_report()
    pool = init_paged_cache(port_cfg(cfg), 3, 8)
    jpool = build_model(cfg).init_paged_cache(3, 8)
    assert set(pool) == set(jpool)
    for k, v in pool.items():
        assert tuple(v.shape) == jpool[k].shape
        assert str(v.dtype).replace("torch.", "") == str(jpool[k].dtype)


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    from repro_torch.models import init_params
    return init_params(port_cfg(tiny_cfg("dense")), seed=0)


def _engine(params, kv, **kw):
    kw = dict(dict(num_slots=4, max_len=64, block_size=8), **kw)
    return Engine(port_cfg(tiny_cfg("dense", kv_cache_dtype=kv)), params,
                  device="cpu", **kw)


def _run(eng, prompts, max_new=9):
    reqs = [Request(rid=i, prompt=list(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    stats = eng.run(reqs)
    return [r.tokens for r in reqs], stats


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_quantized_speculative_greedy_equals_sequential(params, kv):
    want = _engine(params, kv).generate_ids(RAGGED, max_new=13)
    got = _engine(params, kv, spec_k=4).generate_ids(RAGGED, max_new=13)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_prefix_sharing_forks_scale_planes(params, kv,
                                                     monkeypatch):
    """Copy-on-write forks copy every pool leaf, the scale planes with the
    payload, and greedy tokens are equal with sharing on and off."""
    want, _ = _run(_engine(params, kv), SHARED)
    on = _engine(params, kv, prefix_cache=True)
    forks = []
    executed = Scheduler.cow_executed

    def spy(sched, si):
        src, dst = sched.slots[si].cow
        for name, buf in on._pool.items():
            a, b = buf[:, src], buf[:, dst]
            if buf.element_size() == 1:
                a, b = a.view(torch.uint8), b.view(torch.uint8)
            assert torch.equal(a, b), name
        forks.append(sorted(on._pool))
        return executed(sched, si)

    monkeypatch.setattr(Scheduler, "cow_executed", spy)
    cold, _ = _run(on, SHARED)
    warm, stats = _run(on, SHARED)
    assert want == cold == warm
    assert forks and all(f == ["k", "k_scale", "v", "v_scale"]
                         for f in forks)
    assert stats["prefix"]["forked"] > 0


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_byte_budget_churn_matches_solo(params, kv):
    """A byte-budget pool too small for all requests at once: every
    request completes, and its tokens equal a fresh quantized engine
    serving it alone."""
    rng = np.random.default_rng(0)
    bpb = paged_block_bytes(port_cfg(tiny_cfg("dense", kv_cache_dtype=kv)),
                            8)
    eng = _engine(params, kv, num_slots=2, max_len=24, pool_bytes=6 * bpb)
    assert eng.num_blocks == 6 and eng.bytes_per_block == bpb
    prompts = [rng.integers(1, 90, size=int(rng.integers(1, 12))).tolist()
               for _ in range(9)]
    reqs = [Request(rid=i, prompt=p, max_new=int(rng.integers(1, 8)))
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    solo = _engine(params, kv, num_slots=2, max_len=24)
    for r in reqs:
        assert len(r.tokens) == r.max_new
        np.testing.assert_array_equal(
            r.tokens, solo.generate_ids([r.prompt], max_new=r.max_new)[0])


def test_quantized_pool_budget_fits_more_blocks(params):
    f32 = _engine(params, "", pool_bytes=65536)
    fp8 = _engine(params, "fp8", pool_bytes=65536)
    rep = fp8.kv_report()
    assert rep["kv_pool_dtype"] == "float8_e4m3fn"
    # 1-byte payload + two f32 scales per (token, head): 40/128 of f32
    assert fp8.bytes_per_block * 128 == f32.bytes_per_block * 40
    assert fp8.num_blocks == 65536 // fp8.bytes_per_block > f32.num_blocks


def test_serve_cli_runs_a_quantized_pool_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--prompt", "compute 3 + 4 .",
                    "--max-new", "4", "--max-len", "64", "--kv-dtype",
                    "fp8_e5m2", "--report"])
    out = buf.getvalue()
    assert "# kv_dtype=fp8_e5m2 (pool float8_e5m2)" in out


# ---------------------------------------------------------------------------
# Training with fp8_matmul
# ---------------------------------------------------------------------------

def test_lm_loss_with_fp8_matmul_equals_jax():
    """The JAX package's training attention has no fp8 path, so
    ``fp8_matmul`` leaves the loss as it is, in both packages."""
    cfg = tiny_cfg("dense", fp8_matmul=True)
    params, _ = jax_init_params(cfg, jax.random.key(1))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, _ = jax_lm_loss(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, cfg)
    tparams = port_params(cfg, params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, _ = lm_loss(tparams, tbatch, port_cfg(cfg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    plain, _ = lm_loss(tparams, tbatch, port_cfg(tiny_cfg("dense")))
    assert float(got) == float(plain)
