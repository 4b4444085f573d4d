"""The port's mamba-2 (SSM) slice against the JAX package: the plain SSD
scan against ``ssd_chunked``, the interpret-mode Pallas kernel and the
one-token recurrence; the mamba block's forward and decode step; the
SSM ``forward_lm`` and ``decode_step_lm``; and the engine's static path
and scoring on a tiny SSM.  Inputs come from a numpy seed and go through
both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.kernels.ssd import ssd as jax_ssd_kernel
from repro.models import ssm as jax_ssm
from repro.models.transformer import build_model
from repro.models.transformer import forward_lm as jax_forward_lm
from repro.models.transformer import init_params as jax_init
from repro.serving import Engine as JaxEngine
from repro_torch import Engine
from repro_torch.kernels.ssd import ssd, ssd_chunked, ssd_decode_step
from repro_torch.kernels.ssd.ops import chunk_len
from repro_torch.models import (decode_step_lm, forward_lm,
                                init_decode_cache)
from repro_torch.models import ssm
from torch_cases import ssd_inputs
from torch_parity import RAGGED, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

# the JAX package's SSD sweep (tests/test_kernels.py): padding, one chunk
SWEEP = [(2, 64, 4, 16, 32, 16), (1, 100, 2, 8, 16, 32),
         (1, 128, 8, 32, 64, 128), (2, 96, 1, 64, 8, 16)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg("ssm")
    params, _ = jax_init(cfg, jax.random.key(0))
    return cfg, params, port_params(cfg, params)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _tlayer(tree, i):
    return {k: _tlayer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_plain_ssd_matches_jax_ssd_chunked(B, S, H, P, N, chunk):
    inp = ssd_inputs(S + N, B, S, H, P, N)
    y, h = ssd_chunked(*_t(*inp), chunk=chunk)
    yr, hr = jax_ssm.ssd_chunked(*_j(*inp), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEP)
def test_plain_ssd_matches_interpret_pallas_kernel(B, S, H, P, N, chunk):
    inp = ssd_inputs(S + N + 1, B, S, H, P, N)
    y, h = ssd(*_t(*inp), chunk=chunk)          # CPU: the plain version
    yk, hk = jax_ssd_kernel(*_j(*inp), chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hk), atol=1e-4,
                               rtol=1e-4)


def test_plain_ssd_matches_the_sequential_recurrence():
    B, S, H, P, N = 2, 37, 3, 8, 4
    x, dt, A, Bm, Cm, D = _t(*ssd_inputs(9, B, S, H, P, N, D_val=0.5))
    y, hT = ssd_chunked(x, dt, A, Bm, Cm, D, chunk=8)
    h = torch.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        yt, h = ssd_decode_step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                                D)
        ys.append(yt)
    torch.testing.assert_close(y, torch.stack(ys, 1), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hT, h, atol=1e-4, rtol=1e-4)


def test_plain_decode_step_matches_jax():
    B, H, P, N = 2, 3, 8, 4
    rng = np.random.default_rng(4)
    h = rng.standard_normal((B, H, N, P)).astype(np.float32)
    x, dt, A, Bm, Cm, D = ssd_inputs(5, B, 1, H, P, N, D_val=0.5)
    args = (h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D)
    y, hn = ssd_decode_step(*_t(*args))
    yr, hr = jax_ssm.ssd_decode_step(*_j(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-6)
    np.testing.assert_allclose(hn.numpy(), np.asarray(hr), atol=1e-6)


@pytest.mark.parametrize("S,chunk,Q", [(512, 128, 128), (300, 128, 128),
                                       (64, 128, 64), (12, 8, 8),
                                       (16, 16, 16)])
def test_chunk_rule_copies_the_jax_wrapper(S, chunk, Q):
    """Q = min(chunk, S) if S % chunk else chunk (repro/kernels/ssd/ops.py),
    which is also the plain version's Q = min(chunk, S)."""
    assert chunk_len(S, chunk) == Q == min(chunk, S)


# ---------------------------------------------------------------------------
# The mamba block
# ---------------------------------------------------------------------------

def test_init_mamba_shapes_and_rules():
    cfg = port_cfg(tiny_cfg("ssm"))
    g = torch.Generator().manual_seed(0)
    p = ssm.init_mamba(g, cfg, stack=(3,))
    want = build_model(tiny_cfg("ssm")).init(jax.random.key(0))
    jl = jax.tree.map(lambda px: px.value.shape,
                      want["layers"]["mamba"],
                      is_leaf=lambda v: hasattr(v, "names"))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: (3,) + tuple(s)[1:] for k, s in jl.items()}
    a = torch.exp(p["A_log"])
    assert bool(((a >= 1.0) & (a < 16.0)).all())
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt > 0.999e-3) & (dt < 1.001e-1)).all())
    assert bool((p["conv_b"] == 0).all() and (p["D"] == 1).all())
    assert float(p["in_proj"].abs().max()) <= 3 / 8 + 1e-6   # 3/sqrt(64)


def test_apply_mamba_matches_reference(tiny):
    cfg, params, tparams = tiny
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    got = ssm.apply_mamba(_tlayer(tparams["layers"]["mamba"], 1),
                          torch.from_numpy(x), port_cfg(cfg))
    want = jax_ssm.apply_mamba(_layer(params["layers"]["mamba"], 1),
                               jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_mamba_matches_reference(tiny):
    cfg, params, tparams = tiny
    pc = port_cfg(cfg)
    rng = np.random.default_rng(2)
    cache = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in ssm.init_mamba_cache(pc, 3).items()}
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, tcache = ssm.decode_mamba(_tlayer(tparams["layers"]["mamba"], 0),
                                   torch.from_numpy(x), pc, tcache)
    want, jcache = jax_ssm.decode_mamba(
        _layer(params["layers"]["mamba"], 0), jnp.asarray(x), cfg,
        {k: jnp.asarray(v) for k, v in cache.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_ssm_forward_lm_matches_reference(tiny, use_pallas):
    """The port has one scan (the kernel on the card, ``ssd_chunked`` on
    the CPU) whatever ``use_pallas`` says; the JAX package's two paths
    both land within 1e-5."""
    cfg, params, tparams = tiny
    cfg = cfg.with_(use_pallas=use_pallas)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 29),
                                             dtype=np.int32)
    got, _ = forward_lm(tparams, {"tokens": torch.from_numpy(toks)},
                        port_cfg(cfg))
    want, _ = jax_forward_lm(params, {"tokens": jnp.asarray(toks)}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_ssm_decode_step_lm_matches_reference(tiny):
    """A static prefill with a left-pad token (position -1) and a few
    decode steps: logits, conv rings and states each step."""
    cfg, params, tparams = tiny
    pc = port_cfg(cfg)
    model = build_model(cfg)
    B, T = 3, 7
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T),
                                             dtype=np.int32)
    jcache = model.init_cache(B, T)
    tcache = init_decode_cache(pc, B, T)
    for t in range(T):
        pos = np.array([t - 1, t, t], np.int32)
        jl, jcache = model.decode_step(params, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "position": jnp.asarray(np.maximum(pos, -1))})
        tl, tcache = decode_step_lm(tparams, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1]),
            "position": torch.from_numpy(np.maximum(pos, -1))}, pc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tcache["mamba"][k].numpy(),
                                   np.asarray(jcache["mamba"][k]),
                                   atol=1e-5, rtol=1e-5)


def test_ssm_decode_matches_forward_inside_the_port(tiny):
    """Token-by-token decode == the chunked full-sequence forward."""
    cfg, _, tparams = tiny
    pc = port_cfg(cfg)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 19), dtype=np.int32))
    full, _ = forward_lm(tparams, {"tokens": toks}, pc)
    cache = init_decode_cache(pc, 2, 19)
    steps = []
    for t in range(19):
        lg, cache = decode_step_lm(tparams, cache, {
            "token": toks[:, t:t + 1], "position": t}, pc)
        steps.append(lg)
    torch.testing.assert_close(torch.cat(steps, 1), full, atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The engine: static path and scoring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(tiny):
    cfg, params, tparams = tiny
    return (JaxEngine(build_model(cfg), params),
            Engine(port_cfg(cfg), tparams, device="cpu"))


def test_ssm_engine_has_no_pool_and_run_raises(engines):
    _, eng = engines
    assert not eng.continuous
    with pytest.raises(RuntimeError, match="continuous path"):
        eng.run([])


@pytest.mark.parametrize("entry", ["generate_ids", "generate_ids_static"])
def test_ssm_greedy_tokens_equal_jax_engine_on_ragged(engines, entry):
    """Left-pad tokens run through the SSM state before the prompt in both
    packages (the reference's decode ignores positions), so the ragged
    batch's tokens depend on its padding identically."""
    jax_eng, eng = engines
    want = getattr(jax_eng, entry)(RAGGED, max_new=13)
    got = getattr(eng, entry)(RAGGED, max_new=13)
    np.testing.assert_array_equal(got, want)


def test_ssm_pad_tokens_reach_the_state(engines):
    """The reference behaviour the port keeps: a prompt's greedy tokens
    change with the batch's left padding."""
    _, eng = engines
    alone = eng.generate_ids_static([RAGGED[0]], max_new=8)[0]
    padded = eng.generate_ids_static([RAGGED[0], RAGGED[6]], max_new=8)[0]
    assert (alone != padded).any()


def test_ssm_score_continuations_equal_jax_engine(engines):
    jax_eng, eng = engines
    rows = [(p, RAGGED[(i + 3) % len(RAGGED)][:5])
            for i, p in enumerate(RAGGED)]
    want = jax_eng.score_continuations_batch(rows)
    got = eng.score_continuations_batch(rows)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    one = eng.score_continuations(RAGGED[1], [[3, 4], [5]])
    np.testing.assert_allclose(one, jax_eng.score_continuations(
        RAGGED[1], [[3, 4], [5]]), atol=1e-4, rtol=1e-5)
