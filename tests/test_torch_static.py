"""The port's static-bucket serving path on the dense decoder against the
JAX package: the plain ring decode against ``reference_decode_attention``
and the interpret-mode Pallas ``decode_attention`` kernel;
``decode_step_lm`` logits and cache over a wrapped ring; a batch over the
pool's capacity routed to the static path; static against scheduler
greedy tokens inside the port; continuation scoring."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.kernels.decode_attention import decode_attention as jax_ring
from repro.kernels.decode_attention import reference_decode_attention
from repro.models.transformer import build_model
from repro.models.transformer import init_params as jax_init
from repro.serving import Engine as JaxEngine
from repro_torch import Engine
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.models import decode_step_lm, init_decode_cache
from torch_cases import ring_inputs
from torch_parity import RAGGED, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

# the JAX package's ring-decode sweep (tests/test_kernels.py): G 2, 1, 4
# with a window, odd G
RING = [(2, 2, 2, 256, 64, 0), (1, 4, 1, 512, 128, 0),
        (2, 1, 4, 256, 64, 64), (1, 2, 3, 256, 32, 0)]


@pytest.mark.parametrize("B,KV,G,S,D,window", RING)
def test_plain_ring_decode_matches_reference(B, KV, G, S, D, window):
    q, k, v, pos, q_pos, live = ring_inputs(S + D, B + 1, KV, G, S, D)
    got = decode_attention(*(torch.from_numpy(a) for a in
                             (q, k, v, pos, q_pos)), window=window)
    want = reference_decode_attention(*(jnp.asarray(a) for a in
                                        (q, k, v, pos, q_pos)),
                                      window=window)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,KV,G,S,D,window", RING)
def test_plain_ring_decode_matches_interpret_kernel(B, KV, G, S, D, window):
    q, k, v, pos, q_pos, live = ring_inputs(S + D + 1, B + 1, KV, G, S, D)
    got = decode_attention_plain(*(torch.from_numpy(a) for a in
                                   (q, k, v, pos, q_pos)), window)
    want = jax_ring(*(jnp.asarray(a) for a in (q, k, v, pos, q_pos)),
                    window=window, bk=128)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=2e-5, rtol=1e-5)


def test_ring_decode_ignores_dead_slots():
    """Poisoning slots that are empty or past q_pos changes nothing."""
    q, k, v, pos, q_pos, _ = ring_inputs(3, 2, 2, 2, 128, 32, False)
    pos[:, 100:] = np.arange(1000, 1028)
    args = [torch.from_numpy(a) for a in (q, k, v, pos, q_pos)]
    out1 = decode_attention(*args)
    k2, v2 = args[1].clone(), args[2].clone()
    dead = torch.from_numpy((pos < 0) | (pos > q_pos[:, None]))
    k2[dead[:, None].expand_as(k2[..., 0])] = 1e4
    v2[dead[:, None].expand_as(v2[..., 0])] = -1e4
    out2 = decode_attention(args[0], k2, v2, *args[3:])
    assert float((out1 - out2).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# decode_step_lm and the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg("dense")
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, params, port_params(cfg, params)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_step_lm_matches_reference_over_a_wrapped_ring(tiny, window):
    """13 steps through an 8-slot ring (it wraps), a left-pad token at
    position -1 in row 0: logits each step (rows with a live key) and the
    final cache (k, v in the port's (L, B, KV, cap, hd) layout)."""
    cfg, params, tparams = tiny
    cfg = cfg.with_(window=window)
    pc = port_cfg(cfg)
    model = build_model(cfg)
    B, cap, T = 3, 8, 13
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, T),
                                             dtype=np.int32)
    jcache = model.init_cache(B, cap)
    tcache = init_decode_cache(pc, B, cap)
    for t in range(T):
        pos = np.array([t - 1, t, t + 3], np.int32)
        jl, jcache = model.decode_step(params, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "position": jnp.asarray(np.maximum(pos, -1))})
        tl, tcache = decode_step_lm(tparams, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1]),
            "position": torch.from_numpy(np.maximum(pos, -1))}, pc)
        rows = pos >= 0
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=1e-4, rtol=1e-4)
    ja = jcache["attn"]
    assert tcache["attn"]["idx"] == T and (np.asarray(ja["idx"]) == T).all()
    np.testing.assert_array_equal(tcache["attn"]["pos"].numpy(),
                                  np.asarray(ja["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(
            tcache["attn"][key].numpy(),
            np.asarray(ja[key]).transpose(0, 1, 3, 2, 4), atol=1e-5,
            rtol=1e-5)


def _engines(tiny, **kw):
    cfg, params, tparams = tiny
    kw = dict(dict(num_slots=4, max_len=64, block_size=8), **kw)
    return (JaxEngine(build_model(cfg), params, **kw),
            Engine(port_cfg(cfg), tparams, device="cpu", **kw))


def test_over_capacity_batch_takes_the_static_path(tiny):
    """max_len 16 cannot hold the 30-token prompt: the whole batch goes
    down the static path on both sides."""
    jax_eng, eng = _engines(tiny, max_len=16)
    assert not eng._fits(RAGGED, 6)
    want = jax_eng.generate_ids(RAGGED, max_new=6)
    got = eng.generate_ids(RAGGED, max_new=6)
    np.testing.assert_array_equal(got, want)


def test_static_greedy_equals_scheduler_greedy(tiny):
    """The reference's invariant inside the port: on a batch that fits,
    the static bucket and the continuous scheduler emit the same greedy
    tokens."""
    _, eng = _engines(tiny)
    assert eng._fits(RAGGED, 13)
    np.testing.assert_array_equal(eng.generate_ids_static(RAGGED, 13),
                                  eng.generate_ids(RAGGED, max_new=13))


def test_static_path_trims_at_eos(tiny):
    _, eng = _engines(tiny, max_len=16)
    full = eng.generate(RAGGED, max_new=6)
    eos = full[0][2]
    rows = eng.generate(RAGGED, max_new=6, eos_id=eos)
    for row, ref in zip(rows, full):
        cut = ref[:ref.index(eos) + 1] if eos in ref else ref
        assert row == cut


def test_dense_score_continuations_equal_jax_engine(tiny):
    jax_eng, eng = _engines(tiny)
    rows = [(p, RAGGED[(i + 1) % len(RAGGED)][:4])
            for i, p in enumerate(RAGGED)]
    np.testing.assert_allclose(eng.score_continuations_batch(rows),
                               jax_eng.score_continuations_batch(rows),
                               atol=1e-4, rtol=1e-5)
