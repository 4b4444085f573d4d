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
    paged_decode_attention, paged_decode_attention_plain,
    paged_verify_attention, paged_verify_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                         rmsnorm_residual,
                                         rmsnorm_residual_plain)
from torch_cases import paged_tables, pools


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
    with pytest.raises(TypeError, match="q's dtype"):
        paged_decode_attention(q, kp.bfloat16(), kp.bfloat16(),
                               pos[:, None], pos)


@pytest.mark.cuda
def test_cuda_engine_greedy_equals_cpu_engine(cuda):
    """A tiny model served on the card (kernels) and on the CPU (plain
    versions) from the same parameters emits the same greedy tokens."""
    from repro_torch import Engine
    from repro_torch.configs import ModelConfig
    from repro_torch.models import init_params
    from repro_torch.models.transformer import flatten, unflatten
    cfg = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=128, vocab_size=97)
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
