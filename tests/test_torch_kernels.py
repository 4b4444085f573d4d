"""The port's kernel modules against the JAX package: each plain version
(what the wrappers run for CPU tensors) against the JAX oracle AND the
Pallas kernel in interpret mode, on the same numpy inputs; f32, atol
1e-5, live rows only (rows with no attendable key are garbage in every
implementation).  The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` holds them to these plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    paged_decode_attention as pallas_paged_decode,
    paged_verify_attention as pallas_paged_verify,
    reference_paged_decode_attention, reference_paged_verify_attention)
from repro.kernels.rmsnorm import (reference_rmsnorm,
                                   reference_rmsnorm_residual)
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_residual as pallas_rmsnorm_residual
from repro_torch.kernels import _build, launches, reset_launches
from repro_torch.kernels.decode_attention import (
    paged_decode_attention, paged_decode_attention_plain,
    paged_verify_attention, paged_verify_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                         rmsnorm_residual,
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

@pytest.mark.parametrize("R,d", [(8, 64), (40, 96), (7, 1280)])
def test_rmsnorm_plain_matches_jax_oracle_and_pallas(R, d):
    rng = np.random.default_rng(R * d)
    x = (2 * rng.standard_normal((R, d))).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (R, d)
    _close(got, reference_rmsnorm(jnp.asarray(x), jnp.asarray(s)),
           pallas_rmsnorm(jnp.asarray(x), jnp.asarray(s), interpret=True))


@pytest.mark.parametrize("shape", [(3, 8, 64), (5, 1, 96)])
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


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No toolkit, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["rmsnorm"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_attention", {})


def test_build_names_libraries_by_source_hash():
    a, b = _build._lib_path("rmsnorm"), _build._lib_path("paged_attention")
    assert a.parent == b.parent == _build.BUILD_DIR
    assert a.name.startswith("rmsnorm-") and a.suffix == ".so"
    assert a != b and _build._lib_path("rmsnorm") == a
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
