"""Per-layer attention windows and sliding-window block recycling in the
port, on the CPU: ``layer_windows`` against the reference's; the full
forward, ``lm_loss`` gradients, a paged decode and verify step and the
static decode of a ``window_pattern`` config against the JAX package
(the reference's parameters carried across, seeded numpy inputs); the
continuous engine of a uniform-window config (blocks recycled) and of a
pattern (none recycled) against the JAX engine.  In the port, the
reference's own recycling invariants (``tests/test_speculative.py``): a
windowed engine recycles and matches the static path, a windowed budget
admits more than the full footprint would, and churn through a tight
pool with recycling keeps the pool's invariants at spec_k 0 and 4.
Tolerances: logits atol 1e-4, pools atol 1e-5, the loss rtol 1e-6,
gradients atol 1e-6 / rtol 1e-4 (``test_torch_train.py``'s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs import registry as jax_registry
from repro.models.transformer import build_model
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import layer_windows as jax_layer_windows
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.serving import Engine as JaxEngine
from repro.serving.scheduler import Request as JaxRequest
from repro_torch import Engine
from repro_torch.models import (decode_step_lm, decode_step_paged,
                                forward_lm, init_decode_cache, lm_loss,
                                verify_step_paged)
from repro_torch.models.transformer import flatten, layer_windows, unflatten
from repro_torch.serving import KVBlockPool, Request, Scheduler
from torch_cases import paged_tables
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

PATTERNS = {"global_local": dict(window_pattern=(0, 8)),
            "three_layers": dict(num_layers=3, window_pattern=(8, 4, 0))}


@pytest.fixture(scope="module", params=sorted(PATTERNS))
def model(request):
    cfg = tiny_cfg("dense", **PATTERNS[request.param])
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


def _tokens(seed, cfg, B=2, S=24):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama4-scout-17b-a16e",
                                  "mixtral-8x7b", "nanochat-d20"])
def test_layer_windows_are_the_references(arch):
    for get in (jax_registry.get_config, jax_registry.get_reduced):
        cfg = get(arch)
        assert layer_windows(port_cfg(cfg)) == \
            np.asarray(jax_layer_windows(cfg)).tolist()


def test_forward_logits_match_jax(model):
    """24 tokens: every windowed layer's window is exceeded."""
    cfg, m, params, tparams = model
    toks = _tokens(0, cfg)[:, :-1]
    want, _ = m.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = forward_lm(tparams, {"tokens": torch.from_numpy(toks)},
                            port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_lm_loss_and_grads_match_jax(model):
    cfg, _, params, tparams = model
    toks = _tokens(3, cfg)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, cfg), has_aux=True))(params)
    leaves = {k: v.clone().requires_grad_() for k, v in
              flatten(tparams).items()}
    loss, _ = lm_loss(unflatten(leaves), {k: torch.from_numpy(v) for k, v
                                          in batch.items()}, port_cfg(cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    want = jax_flat(jgrads)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("T", [1, 4])
def test_paged_decode_and_verify_step_match_jax(model, T):
    """Caches up to 32 positions over windows of 4 and 8: live rows'
    logits (atol 1e-4) and the pool (atol 1e-5)."""
    cfg, m, params, tparams = model
    rng = np.random.default_rng(10 + T)
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
    assert start.max() > 8
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]),
                                   atol=1e-5, rtol=0)


def test_static_decode_matches_jax_over_a_wrapped_ring(model):
    """15 steps through a 12-slot ring (it wraps) with a left-pad token:
    logits of rows with a live key (atol 1e-4), the cache (atol 1e-5)."""
    cfg, m, params, tparams = model
    pc = port_cfg(cfg)
    B, cap, T = 3, 12, 15
    toks = _tokens(2, cfg, B=B, S=T)
    jcache = m.init_cache(B, cap)
    tcache = init_decode_cache(pc, B, cap)
    jstep = jax.jit(m.decode_step)
    for t in range(T):
        pos = np.maximum(np.array([t - 1, t, t + 3], np.int32), -1)
        jl, jcache = jstep(params, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "position": jnp.asarray(pos)})
        tl, tcache = decode_step_lm(tparams, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1].copy()),
            "position": torch.from_numpy(pos)}, pc)
        rows = pos >= 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-4, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache["attn"][key].numpy(),
            np.asarray(jcache["attn"][key]).transpose(0, 1, 3, 2, 4),
            atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The continuous engine: recycling against the JAX engine
# ---------------------------------------------------------------------------

def _engines(cfg_kw, **kw):
    cfg = tiny_cfg("dense", **cfg_kw)
    params, _ = jax_init(cfg, jax.random.key(0))
    kw = dict(dict(num_slots=2, max_len=64, block_size=4), **kw)
    return (JaxEngine(build_model(cfg), params, **kw),
            Engine(port_cfg(cfg), port_params(cfg, params), device="cpu",
                   **kw))


@pytest.mark.parametrize("cfg_kw,recycle", [
    (dict(window=8), True), (dict(window_pattern=(0, 8)), False)])
@pytest.mark.parametrize("spec_k", [0, 4])
def test_windowed_engine_matches_jax_engine(cfg_kw, recycle, spec_k):
    """Greedy tokens and stats (recycled blocks, steps) equal to the JAX
    engine's; a uniform window recycles, a pattern keeps every block; a
    windowed engine bypasses the prefix cache."""
    jeng, eng = _engines(cfg_kw, spec_k=spec_k, prefix_cache=True)
    assert eng._recycle_w == jeng._recycle_w == (8 if recycle else 0)
    assert (eng._tree is None) == (jeng._tree is None) == recycle
    prompts = [[7] * 20, [1, 2, 3] * 6, [4, 5, 9, 4, 5]]
    out = []
    for e, req in ((jeng, JaxRequest), (eng, Request)):
        reqs = [req(rid=i, prompt=list(p), max_new=12)
                for i, p in enumerate(prompts)]
        stats = e.run(reqs)
        out.append(([r.tokens for r in reqs],
                    {k: stats[k] for k in ("recycled_blocks", "step_calls",
                                               "generated")}))
    assert out[0] == out[1]
    assert (out[1][1]["recycled_blocks"] > 0) == recycle


# ---------------------------------------------------------------------------
# The reference's recycling invariants, in the port
# ---------------------------------------------------------------------------

def _port_engine(**kw):
    cfg = tiny_cfg("dense", window=8)
    params, _ = jax_init(cfg, jax.random.key(0))
    kw = dict(dict(num_slots=4, max_len=64, block_size=8), **kw)
    return Engine(port_cfg(cfg), port_params(cfg, params), device="cpu",
                  **kw)


def test_windowed_engine_recycles_blocks_and_matches_static():
    eng = _port_engine(block_size=4, num_slots=2)
    assert eng._recycle_w == 8
    prompts = [[7] * 20, [1, 2, 3] * 6]
    reqs = [Request(rid=i, prompt=list(p), max_new=16)
            for i, p in enumerate(prompts)]
    stats = eng.run(reqs)
    assert stats["recycled_blocks"] > 0
    ref = eng.generate_ids_static(prompts, max_new=16)
    for r, row in zip(reqs, ref):
        np.testing.assert_array_equal(np.asarray(r.tokens), row)


def test_windowed_budget_admits_more_than_full_footprint_would():
    pool = KVBlockPool(num_blocks=10, block_size=4)
    sched = Scheduler(2, pool, max_blocks_per_slot=16, window=8)
    sched.chunk_tokens = 4
    for i in range(2):
        sched.submit(Request(rid=i, prompt=[1] * 40, max_new=20))
    assert len(sched.admit()) == 2
    full = Scheduler(2, KVBlockPool(num_blocks=10, block_size=4),
                     max_blocks_per_slot=16)
    full.chunk_tokens = 4
    with pytest.raises(ValueError, match="needs 15 blocks"):
        full.submit(Request(rid=0, prompt=[1] * 40, max_new=20))


@pytest.mark.parametrize("spec_k", [0, 4])
def test_windowed_churn_with_recycling_preserves_invariants(spec_k):
    """Seven requests whose full footprints overflow a 10-block pool run
    to completion through recycling; the pool ends wholly free; each
    request's tokens equal the static path's."""
    rng = np.random.default_rng(1)
    eng = _port_engine(num_slots=2, max_len=48, block_size=4, num_blocks=10,
                       spec_k=spec_k)
    prompts = [rng.integers(1, 90, size=int(rng.integers(4, 30))).tolist()
               for _ in range(7)]
    reqs = [Request(rid=i, prompt=p, max_new=int(rng.integers(4, 14)))
            for i, p in enumerate(prompts)]
    seen = []
    orig = eng._make_sched

    def make_sched(round_tokens):
        sched = orig(round_tokens)
        seen.append(sched)
        return sched

    eng._make_sched = make_sched
    stats = eng.run(reqs)
    assert stats["recycled_blocks"] > 0
    pool = seen[0].pool
    pool.check_invariants()
    assert pool.num_free == pool.num_blocks
    for r in reqs:
        assert len(r.tokens) == r.max_new, r.rid
        np.testing.assert_array_equal(
            np.asarray(r.tokens),
            eng.generate_ids_static([r.prompt], max_new=r.max_new)[0])
