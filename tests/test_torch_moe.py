"""The MoE layer and the MoE decoders of the port (``models/moe.py``;
mixtral-8x7b and llama4-scout-17b-a16e) against the JAX package, on the
CPU, with the reference's parameters carried across and seeded numpy
inputs: ``apply_moe`` at the published capacity factor 1.25, where
tokens are dropped, with its router loss and its gradients (the router
included); ``lm_loss`` and its gradients on the tiny MoE and the two
reduced configs; a paged decode and verify step; the static decode and
the continuous engine of a windowed MoE.  In the port: decode == forward
and spec == non-spec == static at a factor that drops nothing, the
dispatch's backward free of scatter-adds, and the same bits on a second
call.  Tolerances: outputs atol 1e-5, logits atol 1e-4, the loss rtol
1e-6 and gradients atol 1e-6 / rtol 1e-4 (``test_torch_train.py``'s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs import registry as jax_registry
from repro.models import moe as jax_moe
from repro.models.transformer import build_model
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.serving import Engine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch import Engine
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import (decode_step_lm, decode_step_paged,
                                forward_lm, init_decode_cache, lm_loss,
                                verify_step_paged)
from repro_torch.models import moe
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.serving import Request
from torch_cases import paged_tables
from torch_parity import RAGGED, jax_flat, port_cfg, port_params

torch.set_num_threads(1)

MOE_ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e"]


def _moe_params(cfg, seed=0):
    p = jax_moe.init_moe(jax.random.key(seed), cfg)
    jp = {k: v.value for k, v in p.items()}
    return jp, {k: torch.from_numpy(np.asarray(v).copy())
                for k, v in jp.items()}


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# apply_moe against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,shared,K,factor", [
    (2, 16, 0, 2, 1.25), (4, 37, 0, 2, 1.25), (1, 1, 0, 2, 1.25),
    (3, 5, 1, 1, 1.25), (2, 16, 1, 1, 0.5), (3, 5, 0, 2, 0.5)])
def test_apply_moe_matches_jax_with_drops(B, S, shared, K, factor):
    """Output (atol 1e-5) and router loss (rtol 1e-6); the capacity, and
    so the dropped entries, come from the same stable sort."""
    cfg = tiny_cfg("moe", num_shared_experts=shared, num_experts_per_tok=K,
                   moe_capacity_factor=factor)
    jp, tp = _moe_params(cfg, seed=S)
    x = _x(cfg, B, S, seed=B)
    want, jaux = jax.jit(lambda p, xx: jax_moe.apply_moe(p, xx, cfg))(
        jp, jnp.asarray(x))
    got, aux = moe.apply_moe(tp, torch.from_numpy(x), port_cfg(cfg))
    dropped = int(moe.dropped_entries(tp, torch.from_numpy(x),
                                      port_cfg(cfg)))
    assert 0 <= dropped < B * S * K
    if factor == 0.5 and S >= 5:
        assert dropped > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def test_capacity_is_the_references():
    cfg = port_cfg(tiny_cfg("moe"))
    for S in (1, 5, 16, 37):
        assert moe.capacity(cfg, S) == max(int(np.ceil(S * 2 / 4 * 1.25)),
                                           2)


@pytest.mark.parametrize("shared,K", [(0, 2), (1, 1)])
def test_apply_moe_gradients_match_jax_vjp(shared, K):
    """Gradients of <y, r> + 3 aux w.r.t. x and every leaf (router
    included) against ``jax.vjp``, drops included (factor 1.25)."""
    cfg = tiny_cfg("moe", num_shared_experts=shared, num_experts_per_tok=K)
    jp, tp = _moe_params(cfg, seed=4)
    x = _x(cfg, 2, 16, seed=5)
    r = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def f(p, xx):
        y, aux = jax_moe.apply_moe(p, xx, cfg)
        return jnp.sum(y * r) + 3.0 * aux

    jg_p, jg_x = jax.jit(jax.grad(f, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(leaves, xt, port_cfg(cfg))
    out = (y * torch.from_numpy(r)).sum() + 3.0 * aux
    grads = torch.autograd.grad(out, [xt] + list(leaves.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_x),
                               atol=1e-6, rtol=1e-4)
    for k, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_p[k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
    assert float(grads[1 + list(leaves).index("router")].abs().max()) > 0


def test_dispatch_backward_has_no_scatter_add():
    """The graph from the output back to x holds the two gathers' own
    backward nodes and no gather, index or scatter-add backward (their
    backward adds with atomics on CUDA)."""
    cfg = tiny_cfg("moe")
    _, tp = _moe_params(cfg)
    xt = torch.from_numpy(_x(cfg, 2, 16, 0)).requires_grad_()
    y, aux = moe.apply_moe(tp, xt, port_cfg(cfg))
    names, todo, seen = set(), [(y + aux).grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    assert {"_DispatchBackward", "_CombineBackward"} <= names
    bad = {n for n in names if any(w in n for w in (
        "Gather", "Index", "ScatterAdd", "Embedding"))}
    assert not bad, bad


def test_second_call_gives_the_same_bits():
    cfg = tiny_cfg("moe")
    _, tp = _moe_params(cfg)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = torch.from_numpy(_x(cfg, 3, 11, 1))
    outs = []
    for _ in range(2):
        y, aux = moe.apply_moe(leaves, x, port_cfg(cfg))
        outs.append([y, aux] + list(torch.autograd.grad(
            y.square().sum() + aux, list(leaves.values()))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The MoE decoders against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["tiny"] + MOE_ARCHS)
def model(request):
    cfg = tiny_cfg("moe", window=8) if request.param == "tiny" else \
        jax_registry.get_reduced(request.param)
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


def _tokens(seed, cfg, B=2, S=20):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg("moe", window=8)
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_configs_keep_at_most_four_experts(arch):
    red = get_reduced(arch)
    assert red.num_experts == min(get_config(arch).num_experts, 4)
    assert red.num_shared_experts == get_config(arch).num_shared_experts


def test_lm_loss_aux_and_grads_match_jax(tiny):
    """Loss (ce + router_aux_coef * aux, rtol 1e-6), aux (rtol 1e-6) and
    every gradient leaf (atol 2e-6 in units of the leaf's largest
    gradient where that exceeds 1, rtol 1e-4), one label ignored.  The
    atol is twice the dense configs' (``test_torch_archs.py``): the
    largest gap seen, 1.14e-6, is one element of llama4-scout reduced's
    embedding gradient, a sum of near-cancelling terms (rel 2.4e-3).
    The reduced configs are ``test_torch_archs.py``'s."""
    cfg, _, params, tparams = tiny
    toks = _tokens(3, cfg)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    batch["labels"][1, 4] = -1
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg), has_aux=True))(params)
    leaves = {k: v.clone().requires_grad_() for k, v in
              flatten(tparams).items()}
    loss, m = lm_loss(unflatten(leaves), {k: torch.from_numpy(v) for k, v
                                          in batch.items()}, port_cfg(cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(m["aux"].item(), float(jm["aux"]), rtol=1e-6)
    assert m["aux"].item() > 0
    want = jax_flat(jgrads)
    assert set(want) == set(leaves)
    for k, g in zip(leaves, grads):
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(g.numpy(), want[k], atol=2e-6 * scale,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("T", [1, 4])
def test_paged_decode_and_verify_step_match_jax(tiny, T):
    """One decode (T 1) or verify (T 4) step over a random pool, ragged
    tables, an unmapped block, an inactive slot: live rows' logits (atol
    1e-4) and the pool (atol 1e-5); capacity over each slot's T tokens
    (the reduced configs are ``test_torch_archs.py``'s)."""
    cfg, m, params, tparams = tiny
    rng = np.random.default_rng(T)
    S, bs, MB = 5, 8, 4
    NB = S * MB + 3
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    pool = {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}
    tokens = rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32)
    t = np.arange(T)[None, :]
    pos = np.where((start[:, None] >= 0) & (t < n_tok[:, None]),
                   start[:, None] + t, -1).astype(np.int32)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    if T == 1:
        jb = {"token": tokens, "position": pos[:, 0], "block_table": tables}
        want, jpool = m.decode_step_paged(
            params, jpool, {k: jnp.asarray(v) for k, v in jb.items()})
        step = decode_step_paged
    else:
        jb = {"tokens": tokens, "positions": pos, "block_table": tables}
        want, jpool = m.verify_step_paged(
            params, jpool, {k: jnp.asarray(v) for k, v in jb.items()})
        step = verify_step_paged
    got, _ = step(tparams, tpool, {k: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in jb.items()}, port_cfg(cfg))
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]),
                                   atol=1e-5, rtol=0)


def test_static_decode_matches_jax(model):
    """14 static decode steps (capacity per one token a row), a left-pad
    token in row 0: logits of rows with a live key (atol 1e-4)."""
    cfg, m, params, tparams = model
    pc = port_cfg(cfg)
    B, T = 3, 14
    toks = _tokens(5, cfg, B=B, S=T)
    jcache = m.init_cache(B, T + 3)
    tcache = init_decode_cache(pc, B, T + 3)
    jstep = jax.jit(m.decode_step)
    for t in range(T):
        pos = np.maximum(np.array([t - 1, t, t + 2], np.int32), -1)
        jl, jcache = jstep(params, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "position": jnp.asarray(pos)})
        tl, tcache = decode_step_lm(tparams, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1].copy()),
            "position": torch.from_numpy(pos)}, pc)
        rows = pos >= 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-4, rtol=0)


def test_windowed_moe_engine_matches_jax_engine():
    """The continuous engine of a windowed tiny MoE (window 8, so blocks
    are recycled) at the published factor 1.25: greedy tokens equal to
    the JAX engine's, and the same recycled-block count."""
    cfg = tiny_cfg("moe", window=8)
    params, _ = jax_init(cfg, jax.random.key(0))
    kw = dict(num_slots=3, max_len=64, block_size=4)
    jeng = JaxEngine(build_model(cfg), params, **kw)
    eng = Engine(port_cfg(cfg), port_params(cfg, params), device="cpu", **kw)
    prompts = [[7] * 20, [1, 2, 3] * 6, [5, 9]]
    out = []
    for e, req in ((jeng, JaxRequest), (eng, Request)):
        reqs = [req(rid=i, prompt=list(p), max_new=10)
                for i, p in enumerate(prompts)]
        stats = e.run(reqs)
        out.append(([r.tokens for r in reqs], stats["recycled_blocks"]))
    assert out[0] == out[1]
    assert out[1][1] > 0


# ---------------------------------------------------------------------------
# In-port invariants at a factor that drops nothing (E / K and above)
# ---------------------------------------------------------------------------

def test_decode_matches_forward_without_drops():
    """The reference's ``test_decode_matches_forward`` for moe: 24
    one-token static decode steps against one full forward at factor 8
    (atol 3e-3, the reference's; the port sits far inside it)."""
    cfg = port_cfg(tiny_cfg("moe", moe_capacity_factor=8.0))
    jcfg = tiny_cfg("moe", moe_capacity_factor=8.0)
    tparams = port_params(jcfg, jax_init(jcfg, jax.random.key(1))[0])
    S = 24
    toks = torch.from_numpy(_tokens(2, cfg, S=S)[:, :S].copy())
    with torch.no_grad():
        full, _ = forward_lm(tparams, {"tokens": toks}, cfg)
        cache = init_decode_cache(cfg, 2, S)
        outs = []
        for t in range(S):
            lg, cache = decode_step_lm(tparams, cache, {
                "token": toks[:, t:t + 1], "position": t}, cfg)
            outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    assert float((dec - full).abs().max()) < 1e-4


@pytest.mark.parametrize("window", [0, 8])
def test_spec_and_chunked_prefill_equal_static_without_drops(window):
    """At factor E/K (2 for the tiny MoE: no token dropped at any T)
    greedy tokens are
    equal across spec_k 0 (chunked prefill of 8 token-steps), spec_k 4
    and the static path, and the windowed engine recycles blocks."""
    jcfg = tiny_cfg("moe", moe_capacity_factor=2.0, window=window)
    cfg = port_cfg(jcfg)
    tparams = port_params(jcfg, jax_init(jcfg, jax.random.key(0))[0])
    prompts = [list(p) for p in RAGGED[:5]]
    prompts[1] = prompts[1] + prompts[1][2:6]        # a draft to accept
    runs = []
    for spec_k in (0, 4):
        eng = Engine(cfg, tparams, device="cpu", num_slots=3, max_len=64,
                     block_size=4, spec_k=spec_k)
        reqs = [Request(rid=i, prompt=p, max_new=12)
                for i, p in enumerate(prompts)]
        stats = eng.run(reqs)
        runs.append([r.tokens for r in reqs])
        if window:
            assert stats["recycled_blocks"] > 0
        if spec_k:
            assert stats["drafted"] > 0
    static = eng.generate_ids_static(prompts, max_new=12).tolist()
    assert runs[0] == runs[1] == static
