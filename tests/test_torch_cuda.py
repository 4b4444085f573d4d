"""The port's CUDA kernels against their plain PyTorch versions, on a
card.  Marked ``cuda``: they skip without one.  This file imports no JAX,
so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_dequant,
    paged_decode_attention_dequant_plain, paged_decode_attention_plain,
    paged_verify_attention, paged_verify_attention_dequant,
    paged_verify_attention_dequant_plain, paged_verify_attention_plain)
from repro_torch.kernels.quantize import quantize_axis
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                         rmsnorm_residual,
                                         rmsnorm_residual_plain)
from torch_cases import (paged_tables, pools, ring_inputs, split_inputs,
                        ssd_inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_rmsnorm_kernels_match_plain(cuda, dtype, atol):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((40, 1280), generator=g).to(dtype).to(cuda)
    r = torch.randn((40, 1280), generator=g).to(dtype).to(cuda)
    s = torch.randn(1280, generator=g).to(cuda)
    torch.testing.assert_close(rmsnorm(x, s), rmsnorm_plain(x, s),
                               atol=atol, rtol=atol)
    torch.testing.assert_close(rmsnorm_residual(x, r, s),
                               rmsnorm_residual_plain(x, r, s),
                               atol=atol, rtol=atol)


# widths of the layout's variants (warp-wide rows to 2048, CTA-wide above;
# 1600 masks part of its last tile) and row counts of the main path
NORM_WIDTHS = (64, 96, 1280, 1600, 2048, 12288)
NORM_ROWS = (1, 8, 40, 300, 4096)
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _norm_inputs(cuda, rows, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x, r, dy, dh = (torch.randn((rows, d), generator=g).to(dtype).to(cuda)
                    for _ in range(4))
    s = (1 + 0.1 * torch.randn(d, generator=g)).to(cuda)
    return x, r, s, dy, dh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_cuda_rmsnorm_kernels_match_plain_at_every_width(cuda, dtype, d):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
    tol = NORM_TOL[dtype]
    for rows in NORM_ROWS[:4] if d > 2048 else NORM_ROWS:
        x, r, s, dy, dh = _norm_inputs(cuda, rows, d, dtype, rows + d)
        torch.testing.assert_close(rmsnorm(x, s), rmsnorm_plain(x, s),
                                   atol=tol, rtol=tol)
        torch.testing.assert_close(rmsnorm_residual(x, r, s),
                                   rmsnorm_residual_plain(x, r, s),
                                   atol=tol, rtol=tol)
        for kw in ({}, dict(residual=r, dh=dh)):
            got = rmsnorm_bwd(dy, x, s, **kw)
            want = rmsnorm_bwd_plain(dy, x, s, 1e-5, kw.get("residual"),
                                     kw.get("dh"))
            torch.testing.assert_close(got[0], want[0], atol=tol, rtol=tol)
            # dscale sums the rows in another order
            torch.testing.assert_close(got[1], want[1], atol=1e-3,
                                       rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 1280, 2048, 12288])
def test_cuda_rmsnorm_rows_independent_of_the_launch(cuda, dtype, d):
    """A row's bits do not depend on the rows launched with it: 40 rows
    in one launch, as 8-row slices and one by one, bit for bit (forward,
    both variants, and the backward's dx)."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    x, r, s, dy, dh = _norm_inputs(cuda, 40, d, dtype, d)

    def run(a, b):
        o, h = rmsnorm_residual(x[a:b], r[a:b], s)
        return (rmsnorm(x[a:b], s), o, h, rmsnorm_bwd(dy[a:b], x[a:b], s)[0],
                rmsnorm_bwd(dy[a:b], x[a:b], s, residual=r[a:b],
                            dh=dh[a:b])[0])

    whole = run(0, 40)
    for step in (8, 1):
        parts = [run(a, a + step) for a in range(0, 40, step)]
        for k, got in enumerate(whole):
            assert torch.equal(got, torch.cat([p[k] for p in parts])), (
                step, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_cuda_rmsnorm_bwd_is_deterministic(cuda, dtype, residual):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    x, r, s, dy, dh = _norm_inputs(cuda, 4096, 1280, dtype, 3)
    kw = dict(residual=r, dh=dh) if residual else {}
    first = rmsnorm_bwd(dy, x, s, **kw)
    second = rmsnorm_bwd(dy, x, s, **kw)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_cuda_rmsnorm_refuses_widths_and_misaligned_rows(cuda):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    for d in (1284, 12296):
        x = torch.ones((2, d), device=cuda)
        s = torch.ones(d, device=cuda)
        for call in (lambda: rmsnorm(x, s), lambda: rmsnorm_residual(x, x, s),
                     lambda: rmsnorm_bwd(x, x, s)):
            with pytest.raises(ValueError, match="multiple of 8"):
                call()
    flat = torch.ones(2 * 64 + 1, device=cuda)
    x, s = flat[1:].view(2, 64), torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        rmsnorm(x, s)


@pytest.mark.cuda
@pytest.mark.parametrize("T,G,window", [(1, 1, 0), (1, 2, 0), (5, 1, 0),
                                        (5, 2, 0), (1, 1, 64), (5, 1, 64)])
def test_cuda_paged_kernels_match_plain(cuda, T, G, window):
    rng = np.random.default_rng(T * 10 + G)
    S, KV, bs, MB, D = 8, 10 // G, 16, 32, 128
    NB = S * MB
    shape = (S, KV, G, D) if T == 1 else (S, T, KV, G, D)
    q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kp, vp = (torch.from_numpy(a) for a in pools(rng, NB, bs, KV, D))
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    args = [t.to(cuda) for t in (q, kp, vp, torch.from_numpy(tables),
                                 torch.from_numpy(start))]
    if T == 1:
        got = paged_decode_attention(*args, window=window)
        want = paged_decode_attention_plain(*args, window)
        mask = live[:, 0]
    else:
        nt = torch.from_numpy(n_tok).to(cuda)
        got = paged_verify_attention(*args, nt, window=window)
        want = paged_verify_attention_plain(*args, nt, window)
        mask = live
    mask = torch.from_numpy(mask).to(cuda)
    torch.testing.assert_close(got[mask], want[mask], atol=1e-5, rtol=1e-4)


def _paged_inputs(cuda, T, G, seed, pool_dtype=torch.float32,
                  q_dtype=torch.float32):
    """nanochat-d20's paged shapes (S 8, KV*G = 10, D 128, bs 16, MB 32)
    on the card; a pool named by a quantize target comes back as
    (payload, scale) pairs of random K/V quantized per (token, head)."""
    rng = np.random.default_rng(seed)
    S, KV, bs, MB, D = 8, 10 // G, 16, 32, 128
    NB = S * MB
    shape = (S, KV, G, D) if T == 1 else (S, T, KV, G, D)
    q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kp, vp = (torch.from_numpy(a) for a in pools(rng, NB, bs, KV, D))
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    if isinstance(pool_dtype, str):
        (kp, ks), (vp, vs) = (quantize_axis(p, dtype=pool_dtype)
                              for p in (kp, vp))
        kv = [kp.to(cuda), vp.to(cuda), ks[..., 0].to(cuda),
              vs[..., 0].to(cuda)]
    else:
        kv = [kp.to(pool_dtype).to(cuda), vp.to(pool_dtype).to(cuda)]
    rest = [torch.from_numpy(tables).to(cuda), torch.from_numpy(start)
            .to(cuda)]
    if T > 1:
        rest.append(torch.from_numpy(n_tok).to(cuda))
    mask = torch.from_numpy(live[:, 0] if T == 1 else live).to(cuda)
    return q.to(q_dtype).to(cuda), kv, rest, mask


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("T,G,window", [(1, 1, 0), (1, 2, 0), (5, 1, 0),
                                        (5, 2, 64)])
@pytest.mark.parametrize("q_dtype,tol", [(torch.float32, 1e-5),
                                         (torch.bfloat16, 1e-2)])
def test_cuda_dequant_kernels_match_plain(cuda, target, T, G, window,
                                          q_dtype, tol):
    q, kv, rest, mask = _paged_inputs(cuda, T, G, T + G, target, q_dtype)
    reset_launches()
    if T == 1:
        got = paged_decode_attention_dequant(q, *kv, *rest, window=window)
        want = paged_decode_attention_dequant_plain(q, *kv, *rest, window)
        name = "paged_decode_dequant"
    else:
        got = paged_verify_attention_dequant(q, *kv, *rest, window=window)
        want = paged_verify_attention_dequant_plain(q, *kv, *rest, window)
        name = "paged_verify_dequant"
    torch.cuda.synchronize()
    assert dict(launches) == {name: 1}
    torch.testing.assert_close(got[mask], want[mask], atol=tol,
                               rtol=10 * tol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool_dtype,tol", [
    (torch.float32, torch.float32, 1e-5),
    (torch.float32, torch.bfloat16, 1e-5),      # narrower pool, fp8 QK^T
    (torch.bfloat16, torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("T,G,window", [(1, 1, 0), (1, 2, 64), (5, 1, 0),
                                        (5, 2, 0)])
@pytest.mark.parametrize("fp8", [False, True])
def test_cuda_plain_pool_kernels_by_pool_dtype_and_fp8(
        cuda, q_dtype, pool_dtype, tol, T, G, window, fp8):
    """The plain-pool kernels on a pool in another dtype than q and with
    the fp8 QK^T (per-row e4m3 Q and K tiles), against their plain
    versions."""
    q, kv, rest, mask = _paged_inputs(cuda, T, G, 3 * T + G, pool_dtype,
                                      q_dtype)
    reset_launches()
    fn, plain = ((paged_decode_attention, paged_decode_attention_plain)
                 if T == 1 else
                 (paged_verify_attention, paged_verify_attention_plain))
    got = fn(q, *kv, *rest, window=window, fp8=fp8)
    want = plain(q, *kv, *rest, window, fp8)
    torch.cuda.synchronize()
    name = ("paged_decode" if T == 1 else "paged_verify") + (
        "_fp8" if fp8 else "")
    assert dict(launches) == {name: 1}
    torch.testing.assert_close(got[mask], want[mask], atol=tol,
                               rtol=10 * tol)


def _split_pool(kp, vp, pool, q_dtype, cuda):
    """The f32 pools as the kernels' ``pool``: a quantize target (payloads
    and (NB, bs, KV) scales), "fp8_qk" (a pool in q's dtype, read with
    the fp8 QK^T) or a torch dtype name.  Returns (kv tensors, dequant?,
    fp8?)."""
    if pool in ("int8", "fp8_e4m3", "fp8_e5m2"):
        (kq, ks), (vq, vs) = (quantize_axis(p, dtype=pool) for p in (kp, vp))
        return [t.to(cuda) for t in (kq, vq, ks[..., 0], vs[..., 0])], \
            True, False
    dt = q_dtype if pool == "fp8_qk" else getattr(torch, pool)
    return [kp.to(dt).to(cuda), vp.to(dt).to(cuda)], False, pool == "fp8_qk"


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool", [
    (torch.float32, "float32"), (torch.float32, "bfloat16"),
    (torch.float32, "int8"), (torch.float32, "fp8_e4m3"),
    (torch.float32, "fp8_e5m2"), (torch.float32, "fp8_qk"),
    (torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
    (torch.bfloat16, "fp8_qk")])
@pytest.mark.parametrize("G,window", [(1, 0), (2, 0), (1, 64), (2, 64)])
def test_cuda_verify_rows_equal_decode_bit_for_bit(cuda, q_dtype, pool, G,
                                                   window):
    """Over a cache of several chunks (MB 16 x bs 16 = 4 chunks of
    CHUNK_KEYS), with a verify range straddling a chunk boundary,
    unmapped blocks and an inactive slot: paged_verify(q)[:, t] equals
    paged_decode(q[:, t]) at q_pos = start + t (-1 where t is padding),
    to the bit, on every pool and with the fp8 QK^T; and verify stays
    within its tolerance of the plain version."""
    from repro_torch.kernels.decode_attention import ops
    q, kp, vp, tab, start, n_tok, live = split_inputs(
        G * 10 + window, KV=10 // G, G=G, D=128, bs=16, MB=16)
    assert ops.split_chunks(16, 16)[1] >= 3
    kv, dequant, fp8 = _split_pool(torch.from_numpy(kp), torch.from_numpy(vp),
                                   pool, q_dtype, cuda)
    q = torch.from_numpy(q).to(q_dtype).to(cuda)
    tab, start, n_tok = (torch.from_numpy(a).to(cuda)
                         for a in (tab, start, n_tok))
    sfx = "_dequant" if dequant else ""
    verify = getattr(ops, f"paged_verify_attention{sfx}")
    decode = getattr(ops, f"paged_decode_attention{sfx}")
    kw = {"window": window, **({"fp8": True} if fp8 else {})}
    reset_launches()
    got = verify(q, *kv, tab, start, n_tok, **kw)
    for t in range(q.shape[1]):
        q_pos = torch.where((t < n_tok) & (start >= 0), start + t,
                            -1).to(torch.int32)
        one = decode(q[:, t].contiguous(), *kv, tab, q_pos, **kw)
        assert torch.equal(got[:, t], one), t
    torch.cuda.synchronize()
    name = "_fp8" if fp8 else sfx
    assert dict(launches) == {f"paged_verify{name}": 1,
                              f"paged_decode{name}": q.shape[1]}
    plain = getattr(ops, f"paged_verify_attention{sfx}_plain")
    want = plain(q, *kv, tab, start, n_tok, window, *((True,) if fp8 else ()))
    tol = 1e-5 if q_dtype == torch.float32 else 1e-2
    mask = torch.from_numpy(live).to(cuda)
    torch.testing.assert_close(got[mask].float(), want[mask].float(),
                               atol=tol, rtol=10 * tol)
    empty = torch.arange(q.shape[1], device=cuda)[None, :] >= n_tok[:, None]
    empty[2] = True                      # slot 2's one block is unmapped
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [0, 40])
def test_cuda_ring_split_edges(cuda, dtype, tol, window):
    """The ring kernel split into chunks of CHUNK_KEYS slots: S 200 is not
    a multiple of the chunk; row 0's slots 64-127 (a whole chunk) are
    dead; row 1's ring is rotated so that its window (40) starts mid-
    chunk; the last row has no live key and gives zeros."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import ring_chunks
    B, KV, G, S, D = 3, 2, 2, 200, 64
    assert S % 64 and ring_chunks(S) == 4
    q, k, v, pos, q_pos, live = ring_inputs(11, B, KV, G, S, D)
    pos[0, 64:128] = -1
    pos[1] = np.roll(pos[1], 90)
    q, k, v = (torch.from_numpy(a).to(dtype).to(cuda) for a in (q, k, v))
    pos, q_pos = (torch.from_numpy(a).to(cuda) for a in (pos, q_pos))
    reset_launches()
    got = decode_attention(q, k, v, pos, q_pos, window=window)
    want = decode_attention_plain(q, k, v, pos, q_pos, window)
    torch.cuda.synchronize()
    assert dict(launches) == {"ring_decode": 1}
    live = torch.from_numpy(live).to(cuda)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=tol, rtol=10 * tol)
    assert bool((got[~live] == 0).all())


@pytest.mark.cuda
def test_cuda_wrappers_count_one_launch_each(cuda):
    x = torch.randn((4, 1, 256), device=cuda)
    s = torch.ones(256, device=cuda)
    q = torch.randn((2, 1, 1, 16), device=cuda)
    kp = torch.randn((2, 4, 1, 16), device=cuda)
    tab = torch.tensor([[0], [1]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([3, -1], dtype=torch.int32, device=cuda)
    one = torch.ones(2, dtype=torch.int32, device=cuda)
    reset_launches()
    rmsnorm(x, s)
    rmsnorm_residual(x, x, s)
    paged_decode_attention(q, kp, kp, tab, pos)
    paged_verify_attention(q[:, None], kp, kp, tab, pos, one)
    torch.cuda.synchronize()
    assert dict(launches) == {"rmsnorm": 1, "rmsnorm_residual": 1,
                              "paged_decode": 1, "paged_verify": 1}


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    s = torch.ones(64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsnorm(torch.ones((2, 64), dtype=torch.float16, device=cuda),
                s.half())
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(torch.ones((2, 64), device=cuda), s[:32])
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(torch.ones((64, 2), device=cuda).t(), s)
    q = torch.ones((1, 1, 1, 16), device=cuda)
    kp = torch.ones((1, 4, 1, 16), device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(q, kp, kp, torch.zeros((1, 1), device=cuda),
                               pos)
    with pytest.raises(TypeError, match="pool dtype"):
        paged_decode_attention(q, kp.half(), kp.half(), pos[:, None], pos)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_kw", [{}, {"kv_cache_dtype": "fp8"},
                                    {"fp8_matmul": True}],
                         ids=["f32", "fp8-pool", "fp8-matmul"])
def test_cuda_engine_greedy_equals_cpu_engine(cuda, cfg_kw):
    """A tiny model served on the card (kernels) and on the CPU (plain
    versions) from the same parameters emits the same greedy tokens, on
    an f32 pool, on an fp8 pool and with the fp8 QK^T."""
    from repro_torch import Engine
    from repro_torch.configs import ModelConfig
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten, unflatten
    cfg = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=97, **cfg_kw)
    params = init_params(cfg, seed=0)
    params_d = unflatten({k: v.to(cuda) for k, v in flatten(params).items()})
    prompts = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [2, 9], [7] * 17,
               [4, 4, 4, 4, 4], [11, 3], [1] * 30, [8]]
    for spec_k in (0, 3):
        kw = dict(num_slots=4, max_len=64, block_size=8, spec_k=spec_k)
        want = Engine(cfg, params, device="cpu", **kw).generate_ids(
            prompts, max_new=13)
        got = Engine(cfg, params_d, device=cuda, **kw).generate_ids(
            prompts, max_new=13)
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_kw", [{"kv_cache_dtype": "fp8"},
                                    {"kv_cache_dtype": "int8"},
                                    {"fp8_matmul": True}],
                         ids=["fp8-pool", "int8-pool", "fp8-matmul"])
@pytest.mark.parametrize("bs,MB", [(4, 4), (16, 16)],
                         ids=["one-chunk", "four-chunks"])
def test_cuda_verify_step_equals_decode_steps_bit_for_bit(cuda, cfg_kw, bs,
                                                          MB):
    """Where the attention quantizes, a verify forward over T tokens per
    slot writes the same pool, to the bit, and gives the same logits as T
    decode forwards on the card: its GEMMs run per token column at the
    decode step's row count (``serving_matmul``) and the paged kernels
    treat each query row alike.  Without that, quantization turns
    last-bit differences into whole quanta and speculative greedy
    decoding parts from sequential.  At bs 16, MB 16 the cache spans four
    chunks of the split kernels."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    init_params, verify_step_paged)
    from repro_torch.models.transformer import flatten, unflatten
    cfg = ModelConfig(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                      d_ff=512, vocab_size=97, **cfg_kw)
    params = unflatten({k: v.to(cuda) for k, v in
                        flatten(init_params(cfg, seed=0)).items()})
    S, T = 8, 5
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 97, (S, T), generator=g, dtype=torch.int32)
    table = torch.arange(S * MB, dtype=torch.int32).reshape(S, MB)
    start = torch.randint(0, MB * bs - T, (S,), generator=g,
                          dtype=torch.int32)
    pos = start[:, None] + torch.arange(T, dtype=torch.int32)
    pools = [init_paged_cache(cfg, S * MB, bs, device=cuda) for _ in "ab"]
    for name in pools[0]:
        if pools[0][name].element_size() == 4:
            fill = torch.rand(pools[0][name].shape, generator=g)
            pools[0][name].copy_(fill)
            pools[1][name].copy_(fill)
    d = lambda t: t.to(cuda)
    chunk, _ = verify_step_paged(params, pools[0], {
        "tokens": d(toks), "positions": d(pos), "block_table": d(table)},
        cfg)
    for t in range(T):
        one, _ = decode_step_paged(params, pools[1], {
            "token": d(toks[:, t:t + 1]), "position": d(pos[:, t]),
            "block_table": d(table)}, cfg)
        assert torch.equal(chunk[:, t], one[:, 0]), t
    for name, a in pools[0].items():
        b = pools[1][name]
        if a.element_size() == 1:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# The training slice's kernels: flash attention forward and backward,
# fused AdamW, the RMSNorm backward
# ---------------------------------------------------------------------------

# (atol, rtol) by dtype.  f32 forward: the serving kernels' tolerance; f32
# backward: 1e-4 + 1e-4, the gradients sum up to G * S products in another
# order than the plain einsums.  bf16: outputs are rounded to 8 mantissa
# bits.
FLASH_TOL = {torch.float32: ((1e-5, 1e-4), (1e-4, 1e-4)),
             torch.bfloat16: ((1e-2, 1e-2), (2e-2, 2e-2))}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 128, 4, 4, 128, None),      # nanochat-d20's head dim, G = 1
    (2, 200, 4, 2, 64, None),       # G = 2, S not a multiple of the tile
    (1, 300, 2, 1, 32, 70),         # sliding window
    (3, 45, 4, 2, 16, None),        # the tiny test model's head dim
    (1, 1, 2, 2, 128, None),        # one position
    (2, 7, 4, 2, 64, None),         # under one 16-row mma block
    (1, 100, 10, 2, 64, None),      # G = 5
    (1, 300, 2, 2, 128, 16),        # a window smaller than a tile
])
def test_cuda_flash_kernels_match_plain(cuda, dtype, B, S, H, KV, D, window):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd,
        flash_fwd)
    g = torch.Generator().manual_seed(S + D)
    q, do = (torch.randn((B, S, H, D), generator=g).to(dtype).to(cuda)
             for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    (fa, fr), (ba, br) = FLASH_TOL[dtype]
    o, lse = flash_fwd(q, k, v, window=window)
    o_ref, lse_ref = flash_attention_plain(q, k, v, True, window)
    torch.testing.assert_close(o, o_ref, atol=fa, rtol=fr)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    got = flash_bwd(q, k, v, o_ref, lse_ref, do, window=window)
    want = flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, True,
                                     window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ba, rtol=br)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_kernels_are_deterministic(cuda, dtype):
    """No atomics: flash_fwd and flash_bwd give the same bits on a second
    call with the same inputs (the pipeline reloads checkpoints bit for bit
    and compares a training step with the CPU)."""
    from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
    g = torch.Generator().manual_seed(11)
    q, do = (torch.randn((2, 300, 4, 128), generator=g).to(dtype).to(cuda)
             for _ in range(2))
    k, v = (torch.randn((2, 300, 2, 128), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    first = flash_fwd(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, flash_fwd(q, k, v)))
    grads = flash_bwd(q, k, v, *first, do)
    again = flash_bwd(q, k, v, *first, do)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["q", "k", "v", "o", "do"])
def test_cuda_flash_kernels_refuse_misaligned_views(cuda, operand):
    """A contiguous view that does not start on a 16-byte boundary (the
    kernels copy tiles in 16-byte chunks) is refused with a ValueError
    naming the operand, before any launch."""
    from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
    g = torch.Generator().manual_seed(12)
    shape = (1, 40, 2, 64)
    ops = {n: torch.randn(shape, generator=g).to(cuda)
           for n in ("q", "k", "v", "do")}
    ops["o"], lse = flash_fwd(ops["q"], ops["k"], ops["v"])
    buf = torch.empty(ops[operand].numel() + 1, device=cuda)
    ops[operand] = buf[1:].view(shape).copy_(ops[operand])
    assert ops[operand].is_contiguous() and ops[operand].data_ptr() % 16
    before = dict(launches)
    with pytest.raises(ValueError, match=rf"aligned.*\b{operand} starts"):
        if operand in ("q", "k", "v"):
            flash_fwd(ops["q"], ops["k"], ops["v"])
        else:
            flash_bwd(ops["q"], ops["k"], ops["v"], ops["o"], lse, ops["do"])
    assert dict(launches) == before


@pytest.mark.cuda
def test_cuda_flash_autograd_matches_autograd_of_plain(cuda):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 150, 4, 64), generator=g).to(cuda).requires_grad_()
    k = torch.randn((2, 150, 2, 64), generator=g).to(cuda).requires_grad_()
    v = torch.randn((2, 150, 2, 64), generator=g).to(cuda).requires_grad_()
    do = torch.randn((2, 150, 4, 64), generator=g).to(cuda)
    reset_launches()
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), do)
    assert launches["flash_fwd"] == 1 and launches["flash_bwd"] == 1
    want = torch.autograd.grad(flash_attention_plain(q, k, v)[0], (q, k, v),
                               do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,pdt,gdt", [(1_000_003, torch.float32,
                                        torch.float32),
                                       (4097, torch.float32, torch.bfloat16),
                                       (77, torch.bfloat16, torch.bfloat16)])
def test_cuda_fused_adamw_matches_plain_bitwise(cuda, n, pdt, gdt):
    """No FMA contraction in the kernel: the same rounded operations as
    the plain version, so the results are equal bit for bit."""
    from repro_torch.kernels.fused_adamw import (fused_adamw_plain,
                                                 fused_adamw_update)
    g = torch.Generator().manual_seed(n)
    p = torch.randn(n, generator=g).to(pdt).to(cuda)
    gr = torch.randn(n, generator=g).to(gdt).to(cuda)
    m = (0.1 * torch.randn(n, generator=g)).to(cuda)
    v = torch.rand(n, generator=g).to(cuda)
    t = torch.tensor(7.0, device=cuda)
    scal = (torch.tensor(1e-3, device=cuda), 1 - 0.9 ** t, 1 - 0.95 ** t)
    kw = dict(b1=0.9, b2=0.95, eps=1e-10, wd=0.01)
    got = fused_adamw_update(p, gr, m, v, *scal, **kw)
    want = fused_adamw_plain(p, gr, m, v, *scal, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("residual", [False, True])
def test_cuda_rmsnorm_bwd_matches_plain_and_autograd(cuda, dtype, atol,
                                                     residual):
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
    g = torch.Generator().manual_seed(int(residual))
    shape = (4, 1000, 1280)           # 4000 rows: the backward's CTAs
    x, r, dy, dh = (torch.randn(shape, generator=g).to(dtype).to(cuda)
                    for _ in range(4))
    s = (1 + 0.1 * torch.randn(1280, generator=g)).to(cuda)
    kw = dict(residual=r, dh=dh) if residual else {}
    got = rmsnorm_bwd(dy, x, s, **kw)
    want = rmsnorm_bwd_plain(dy, x, s, 1e-5, *(
        (r, dh) if residual else ()))
    torch.testing.assert_close(got[0], want[0], atol=atol, rtol=atol)
    # dscale sums 4000 rows: relative tolerance on the column sums
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)
    if dtype == torch.float32:
        xs = [x.clone().requires_grad_(), s.clone().requires_grad_()]
        if residual:
            xs.insert(1, r.clone().requires_grad_())
            out = rmsnorm_residual_plain(*xs)
            ref = torch.autograd.grad(out, xs, (dy, dh))
        else:
            ref = torch.autograd.grad(rmsnorm_plain(*xs), xs, dy)
        torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(got[1], ref[-1], atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_training_step_matches_cpu(cuda):
    """Two DiLoCo rounds (K=2, H=2) of a tiny model with fused AdamW on
    the card (kernels) and on the CPU (plain versions), same params and
    data: losses and final parameters agree."""
    from repro_torch.configs import (DiLoCoConfig, ModelConfig,
                                     OptimizerConfig)
    from repro_torch.core import DistTrainer, DiLoCoSync
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import flatten
    cfg = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=97)
    opt = OptimizerConfig(total_steps=8, warmup_steps=2, fused_adamw=True)
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 97, (4, 2, 2, 33)).astype(np.int32)

    def data(s):
        return {"tokens": toks[s, :, :, :-1], "labels": toks[s, :, :, 1:]}

    out = {}
    for dev in ("cpu", cuda):
        params = {k: v.to(dev) for k, v in
                  flatten(init_params(cfg, seed=0)).items()}
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt, dcfg,
                         DiLoCoSync())
        reset_launches()
        state, hist = dt.run(dt.init(params), data, 4)
        out[str(dev)] = (hist, state.global_params)
        if dev != "cpu":
            for name in ("flash_fwd", "flash_bwd", "fused_adamw",
                         "rmsnorm_bwd"):
                assert launches[name] > 0, name
    (h_cpu, p_cpu), (h_gpu, p_gpu) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(h_gpu["loss"], h_cpu["loss"], rtol=1e-5)
    assert h_gpu["sync_steps"] == h_cpu["sync_steps"] == [1, 3]
    for k, v in p_cpu.items():
        torch.testing.assert_close(p_gpu[k].cpu(), v, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile,residual", [
    ((2, 131072), 0, True), ((1, 1280), 0, True), ((), 0, True),
    ((3, 5, 7), 0, False), ((2, 12807), 256, True), ((2, 1000), 128, False),
    ((2, 0), 0, True)], ids=str)
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_cuda_quantize_kernels_match_plain_bitwise(cuda, dtype, shape, tile,
                                                   residual):
    """quantize_ef (codes, residual, scales) and dequantize equal their
    plain versions on the card bit for bit, per row and per tile, on row,
    3-d, odd-length, scalar and 0-size leaves."""
    from repro_torch.kernels.quantize import (dequantize, dequantize_plain,
                                              quantize_ef, quantize_ef_plain)
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(shape, generator=g) * 0.01).to(cuda)
    r = ((torch.randn(shape, generator=g) * 1e-4).to(cuda) if residual
         else None)
    got = quantize_ef(x, r, dtype=dtype, tile=tile)
    want = quantize_ef_plain(x, r, dtype=dtype, tile=tile)
    bits = lambda t: t.view(torch.uint8) if t.dtype != torch.int8 else t
    assert torch.equal(bits(got[0]), bits(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert got[2].shape == want[2].shape
    assert torch.equal(dequantize(got[0], got[2], tile=tile),
                       dequantize_plain(want[0], want[2], tile=tile))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [0, 256])
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_cuda_quantize_kernels_propagate_nan_and_inf_like_plain(cuda, dtype,
                                                                tile):
    """A NaN or an inf in a row reaches that row's (or tile's) scale, its
    residuals and its decoded values as in the plain version, so a
    diverged worker cannot ship a valid-looking payload; every code whose
    plain decode is a number is equal bit for bit."""
    from repro_torch.kernels.quantize import (dequantize, dequantize_plain,
                                              quantize_ef, quantize_ef_plain)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 1000, generator=g) * 0.01
    x[1, 417] = float("nan")
    x[2, 3] = float("inf")
    x = x.to(cuda)
    r = (torch.randn(3, 1000, generator=g) * 1e-4).to(cuda)
    got = quantize_ef(x, r, dtype=dtype, tile=tile)
    want = quantize_ef_plain(x, r, dtype=dtype, tile=tile)

    def same(a, b):
        return (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(), b.nan_to_num()))
    assert torch.isnan(got[2][1]).any() and torch.isinf(got[2][2]).any()
    assert same(got[1], want[1]) and same(got[2], want[2])
    out = dequantize(got[0], got[2], tile=tile)
    ref = dequantize_plain(want[0], want[2], tile=tile)
    assert same(out, ref) and torch.isnan(ref[1]).any()
    bits = lambda t: t.view(torch.uint8) if t.dtype != torch.int8 else t
    num = ~torch.isnan(ref)
    assert torch.equal(bits(got[0])[num], bits(want[0])[num])


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,kw", [
    ("diloco", dict(delta_dtype="int8")),
    ("streaming", dict(delta_dtype="fp8", num_fragments=2)),
    ("overlapped", dict(delta_dtype="fp8_e5m2", sync_delay=1)),
    ("pipelined", dict(delta_dtype="int8", num_fragments=2, sync_delay=1))])
def test_cuda_lossy_wire_launches_the_quantize_kernels(cuda, strategy, kw):
    """Four steps of a tiny model with a lossy wire on the card: every
    sync goes through quantize_ef and dequantize, and the losses (rtol
    1e-5) and final parameters agree with the CPU run, the parameters
    within 1e-2: a code may differ by a step (up to amax/7 on e5m2) where
    the GEMMs' order moves a value across a rounding boundary."""
    from repro_torch.configs import (DiLoCoConfig, ModelConfig,
                                     OptimizerConfig)
    from repro_torch.core import DistTrainer, make_strategy
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models.transformer import flatten
    cfg = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=97)
    opt = OptimizerConfig(total_steps=8, warmup_steps=2)
    dcfg = DiLoCoConfig(num_workers=2, h_inner_steps=2, strategy=strategy,
                        **kw)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 97, (4, 2, 2, 33)).astype(np.int32)

    def data(s):
        return {"tokens": toks[s, :, :, :-1], "labels": toks[s, :, :, 1:]}

    out = {}
    for dev in ("cpu", cuda):
        params = {k: v.to(dev) for k, v in
                  flatten(init_params(cfg, seed=0)).items()}
        dt = DistTrainer(lambda p, b: lm_loss(p, b, cfg), opt, dcfg,
                         make_strategy(dcfg))
        reset_launches()
        state, hist = dt.run(dt.init(params), data, 4)
        out[str(dev)] = (hist, state.global_params)
        n_syncs = len(hist["sync_steps"]) + len(hist["frag_syncs"])
        if dev != "cpu":
            assert n_syncs and launches["quantize_ef"] >= n_syncs
            assert launches["dequantize"] == launches["quantize_ef"]
        else:
            assert launches["quantize_ef"] == launches["dequantize"] == 0
    (h_cpu, p_cpu), (h_gpu, p_gpu) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(h_gpu["loss"], h_cpu["loss"], rtol=1e-5)
    assert h_gpu["sync_steps"] == h_cpu["sync_steps"]
    assert h_gpu["frag_syncs"] == h_cpu["frag_syncs"]
    for k, v in p_cpu.items():
        torch.testing.assert_close(p_gpu[k].cpu(), v, atol=1e-2, rtol=0)


# ---------------------------------------------------------------------------
# The static serving path and the SSM: the SSD scan and the ring decode
# ---------------------------------------------------------------------------

RAGGED = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [2, 9], [7] * 17,
          [4, 4, 4, 4, 4], [11, 3], [1] * 30, [8]]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 512, 64, 64, 128, 128),     # mamba2-1.3b
    (2, 300, 8, 64, 128, 128),      # padding: S not a multiple of Q
    (1, 64, 8, 64, 128, 128),       # S < chunk: Q = 64
    (4, 144, 64, 64, 128, 128),     # scoring: chunks of 128 and 16 rows
    (2, 100, 2, 16, 32, 32), (1, 37, 3, 8, 4, 8),
    (1, 80, 3, 8, 4, 37)])          # Q 37, a 6-row last chunk
def test_cuda_ssd_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    args = [torch.from_numpy(a).to(cuda)
            for a in ssd_inputs(S + N, B, S, H, P, N, D_val=0.5)]
    reset_launches()
    y, h = ssd(*args, chunk=chunk)
    yp, hp = ssd_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert launches["ssd"] == 1
    torch.testing.assert_close(y, yp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=1e-4)
    xb = args[0].to(torch.bfloat16)
    yb, hb = ssd(xb, *args[1:], chunk=chunk)
    ypb, hpb = ssd_chunked(xb, *args[1:], chunk=chunk)
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(yb.float(), ypb.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(hb, hpb, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_kernel_is_deterministic(cuda, dtype):
    """No atomics: a second call with the same inputs gives the same
    bits."""
    from repro_torch.kernels.ssd import ssd
    args = [torch.from_numpy(a).to(cuda)
            for a in ssd_inputs(7, 4, 144, 64, 64, 128)]
    args[0] = args[0].to(dtype)
    y, h = ssd(*args, chunk=128)
    y2, h2 = ssd(*args, chunk=128)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
def test_cuda_ssd_scratch_does_not_leak_into_the_result(cuda):
    """The wrapper's scratch (chunk states, cumsums, C.B^T) comes from
    torch.empty, so from blocks that earlier calls or other tensors
    used: calls at S 300 and S 144 in turns, and again after the
    allocator's blocks held NaN, give the first calls' bits."""
    from repro_torch.kernels.ssd import ssd
    H, P, N = 8, 64, 128
    inputs = [[torch.from_numpy(a).to(cuda)
               for a in ssd_inputs(S, 2, S, H, P, N)] for S in (300, 144)]
    first = [ssd(*a, chunk=128) for a in inputs]
    again = [ssd(*a, chunk=128) for a in inputs[::-1]][::-1]
    junk = [torch.full((n,), float("nan"), device=cuda)
            for n in (2 ** 16,) * 32 + (2 ** 24,) * 4]
    del junk
    fresh = [ssd(*a, chunk=128) for a in inputs]
    for (y, h), (y2, h2), (y3, h3) in zip(first, again, fresh):
        assert torch.equal(y, y2) and torch.equal(h, h2)
        assert torch.equal(y, y3) and torch.equal(h, h3)


@pytest.mark.cuda
def test_cuda_ssd_refuses_autograd(cuda):
    from repro_torch.kernels.ssd import ssd
    args = [torch.from_numpy(a).to(cuda)
            for a in ssd_inputs(0, 1, 16, 2, 8, 4)]
    args[0].requires_grad_()
    with pytest.raises(NotImplementedError, match="backward"):
        ssd(*args, chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("B,KV,G,S,D,window", [
    (8, 10, 1, 320, 128, 0), (8, 10, 1, 320, 128, 64),
    (3, 2, 2, 256, 64, 0), (2, 1, 4, 100, 64, 16), (2, 2, 3, 256, 32, 0)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_ring_kernel_matches_plain(cuda, B, KV, G, S, D, window, dtype,
                                        tol):
    """Wrapped rings with empty slots; the last row's query at -1 has no
    live key (zeros on the card, the mean of V in the plain version) and
    is not compared."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    q, k, v, pos, q_pos, live = ring_inputs(S + D, B, KV, G, S, D)
    q, k, v = (torch.from_numpy(a).to(dtype).to(cuda) for a in (q, k, v))
    pos, q_pos = (torch.from_numpy(a).to(cuda) for a in (pos, q_pos))
    reset_launches()
    got = decode_attention(q, k, v, pos, q_pos, window=window)
    want = decode_attention_plain(q, k, v, pos, q_pos, window)
    torch.cuda.synchronize()
    assert launches["ring_decode"] == 1
    live = torch.from_numpy(live).to(cuda)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=tol, rtol=10 * tol)
    assert bool((got[~live] == 0).all())


def _tiny(arch):
    from repro_torch.configs import ModelConfig
    if arch == "ssm":
        return ModelConfig(num_layers=2, d_model=64, arch_type="ssm",
                           ssm_state_size=16, ssm_head_dim=16, ssm_chunk=8,
                           num_heads=4, num_kv_heads=4, d_ff=0,
                           vocab_size=97)
    return ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=97)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["ssm", "dense"])
def test_cuda_static_path_and_scoring_equal_cpu(cuda, arch):
    """Greedy static-path tokens on the card equal the CPU's, scores
    agree, and each path launched its kernel: the ring decode on the
    dense static path, the SSD scan once per layer per scoring forward,
    no paged kernel on either."""
    from repro_torch import Engine
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten, unflatten
    cfg = _tiny(arch)
    params = init_params(cfg, seed=0)
    params_d = unflatten({k: v.to(cuda) for k, v in flatten(params).items()})
    kw = dict(num_slots=4, max_len=16, block_size=8)
    cpu = Engine(cfg, params, device="cpu", **kw)
    card = Engine(cfg, params_d, device=cuda, **kw)
    reset_launches()
    got = card.generate_ids(RAGGED, max_new=9)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, cpu.generate_ids(RAGGED, max_new=9))
    assert not any(launches[k] for k in launches if k.startswith("paged"))
    assert (launches["ring_decode"] > 0) == (arch == "dense")
    rows = [(p, RAGGED[(i + 1) % 8][:4]) for i, p in enumerate(RAGGED)]
    reset_launches()
    score = card.score_continuations_batch(rows)
    np.testing.assert_allclose(score, cpu.score_continuations_batch(rows),
                               atol=1e-3, rtol=1e-4)
    assert launches["ssd"] == (cfg.num_layers if arch == "ssm" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (1, 256, 4, 2, 64, True, None), (1, 256, 4, 2, 64, True, 64),
    (1, 256, 4, 2, 64, False, None), (2, 200, 4, 4, 128, True, None),
    (1, 130, 2, 1, 32, True, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_fp8_kernel_matches_plain(cuda, B, S, H, KV, D, causal,
                                             window, dtype, tol):
    """The fp8 QK^T flash forward against its plain version (the JAX
    oracle's quantize-dequantize-attend) within the flash forward's
    tolerance; it differs from the exact kernel by more than 1e-3, so the
    narrow path is live, and launches its own kernel once."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_fp8_plain, flash_fwd)
    g = torch.Generator().manual_seed(S + H + D)
    q = torch.randn((B, S, H, D), generator=g).to(dtype).to(cuda)
    k, v = (torch.randn((B, S, KV, D), generator=g).to(dtype).to(cuda)
            for _ in range(2))
    reset_launches()
    o, lse = flash_fwd(q, k, v, causal=causal, window=window, fp8=True)
    assert launches["flash_fwd_fp8"] == 1 and launches["flash_fwd"] == 0
    o_ref, lse_ref = flash_attention_fp8_plain(q, k, v, causal, window)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=tol * 10, rtol=tol)
    exact, _ = flash_fwd(q, k, v, causal=causal, window=window)
    assert float((o.float() - exact.float()).abs().max()) > 1e-3


@pytest.mark.cuda
def test_cuda_flash_fp8_refuses_the_backward(cuda):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_bwd, flash_fwd)
    q = torch.randn((1, 64, 2, 64), device=cuda)
    o, lse = flash_fwd(q, q, q, fp8=True)
    with pytest.raises(ValueError, match="forward only"):
        flash_bwd(q, q, q, o, lse, o, fp8=True)
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(q, q, q, fp8=True)


@pytest.mark.cuda
def test_cuda_run_pipeline_tiny_matches_cpu(cuda, tmp_path, monkeypatch):
    """The three-stage hybrid pipeline with evals on a tiny model, on the
    card and on the CPU from the same initial parameters (drawn on the
    CPU: the two devices' generators differ): the stage methods, the
    losses (rtol 1e-4) and the held-out CE (rtol 1e-4) agree; the card
    run launched the training kernels and the paged decode kernel of the
    evals, and no verify, quantized-pool, wire, ssd, ring or fp8 kernel;
    every eval value lies in [0, 1]; the final checkpoint reloads to the
    same held-out CE."""
    from repro_torch.checkpoint import (load_config, load_pytree,
                                        params_from_numpy)
    from repro_torch.evals import heldout_metrics
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train
    from repro_torch.launch.train import build_pipeline, run_pipeline
    from repro_torch.models.transformer import flatten, unflatten
    init = train.init_params

    def init_on_cpu(cfg, seed=0, device="cpu"):
        return unflatten({k: v.to(device) for k, v in
                          flatten(init(cfg, seed=seed)).items()})

    monkeypatch.setattr(train, "init_params", init_on_cpu)
    kw = dict(arch="tiny", steps={"base": 6, "mid": 4, "sft": 4}, workers=2,
              per_worker_batch=2, seq_len=64, fused_adamw=True)
    cpu = run_pipeline("hybrid", device="cpu", **kw)
    reset_launches()
    card = run_pipeline("hybrid", device="cuda", out_dir=str(tmp_path), **kw)
    torch.cuda.synchronize()
    counts = {k: launches[k] for k in KERNELS}
    for k in ("flash_fwd", "flash_bwd", "fused_adamw", "rmsnorm_bwd",
              "rmsnorm_residual", "paged_decode"):
        assert counts[k] > 0, k
    for k in ("paged_verify", "paged_decode_dequant", "paged_verify_dequant",
              "paged_decode_fp8", "paged_verify_fp8", "quantize_ef",
              "dequantize", "ssd", "ring_decode", "flash_fwd_fp8"):
        assert counts[k] == 0, k
    for stage in ("base", "mid", "sft"):
        c, g = cpu["stages"][stage], card["stages"][stage]
        assert c["method"] == g["method"]
        np.testing.assert_allclose(g["losses"], c["losses"], rtol=1e-4)
        np.testing.assert_allclose(g["core"]["heldout_ce"],
                                   c["core"]["heldout_ce"], rtol=1e-4)
        assert all(0.0 <= x <= 1.0 for x in g["tasks"].values())
    ckpt = str(tmp_path / "hybrid_final")
    cfg = load_config(ckpt)
    params = params_from_numpy(load_pytree(ckpt), cfg, cuda)
    _, _, stages, _ = build_pipeline(seq_len=64)
    again = heldout_metrics(cfg, params, ds=stages["base"], batches=4,
                            batch_size=8)
    assert again["heldout_ce"] == card["stages"]["sft"]["core"]["heldout_ce"]
