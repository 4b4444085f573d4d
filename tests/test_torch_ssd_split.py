"""The SSD kernel's design (``csrc/ssd.cu``) on the CPU, through its plain
mirror ``ssd_state_passing``: chunk states, state passing, C.B^T once per
(batch row, chunk) and the chunk scan, every product in k-steps of 8 as
the kernel's mma.sync takes them.  Unsplit, the mirror matches the port's
``ssd_chunked`` and the JAX package's within 1e-5; with every operand
split into TF32 hi and lo parts as the kernel splits them (three
products), within the card's gate (``chip_smoke.py`` TOL_SSD); both
match the interpret-mode Pallas kernel as tests/test_torch_ssm.py holds
the plain version to it.  Its chunk cumsums are the plain version's (and
``jnp.cumsum``'s) bits, and skipping the padding's k-steps, as the kernel
does, gives the same bits as running them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd as jax_ssd_kernel
from repro.models import ssm as jax_ssm
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.ssd import ssd_chunked, ssd_state_passing
from repro_torch.kernels.ssd.ref import chunk_cumsum, split_tf32, tf32_round
from torch_cases import ssd_inputs

torch.set_num_threads(1)

# chip_smoke.py's gate of the kernel against ssd_chunked: (atol, rtol)
TOL_SSD = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# (B, S, H, P, N, chunk): the JAX package's sweep (padding, one chunk);
# scoring's S 144 (a chunk of 128 and one of 16 rows); S 300 (a 44-row
# last chunk); the card tests' ragged shapes; Q 37 with N 4, P 8 and a
# 6-row last chunk
SHAPES = [(2, 64, 4, 16, 32, 16), (1, 100, 2, 8, 16, 32),
          (2, 96, 1, 64, 8, 16), (2, 144, 2, 16, 32, 128),
          (1, 300, 2, 8, 16, 128), (1, 37, 3, 8, 4, 8),
          (2, 100, 2, 16, 32, 32), (1, 80, 3, 8, 4, 37)]
PADDED = [(1, 144, 2, 16, 32, 128), (1, 300, 2, 8, 16, 128),
          (1, 37, 3, 8, 4, 8), (1, 80, 3, 8, 4, 37)]


def _inputs(shape, seed_extra=0, D_val=0.5):
    B, S, H, P, N, _ = shape
    return [torch.from_numpy(a) for a in
            ssd_inputs(S + N + seed_extra, B, S, H, P, N, D_val=D_val)]


def _within(got, want, atol, rtol):
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mirror_matches_ssd_chunked_and_jax(shape):
    inp = _inputs(shape)
    chunk = shape[-1]
    y, h = ssd_state_passing(*inp, chunk=chunk)
    yp, hp = ssd_chunked(*inp, chunk=chunk)
    yr, hr = jax_ssm.ssd_chunked(*[jnp.asarray(t.numpy()) for t in inp],
                                 chunk=chunk)
    for got, want in ((y, yp), (h, hp), (y, torch.from_numpy(np.array(yr))),
                      (h, torch.from_numpy(np.array(hr)))):
        _within(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_mirror_within_the_card_gate(shape, dtype):
    """Every product on split TF32 operands (x in bf16 exact, its lo part
    zero) against ssd_chunked within TOL_SSD; the split is live: it moves
    y off the unsplit mirror's bits."""
    inp = _inputs(shape, seed_extra=1)
    inp[0] = inp[0].to(dtype)
    chunk = shape[-1]
    y, h = ssd_state_passing(*inp, chunk=chunk, split=True)
    yp, hp = ssd_chunked(*inp, chunk=chunk)
    assert y.dtype == dtype and h.dtype == torch.float32
    _within(y, yp, *TOL_SSD[dtype])
    _within(h, hp, *TOL_SSD[torch.float32])
    y0, h0 = ssd_state_passing(*inp, chunk=chunk)
    assert not torch.equal(h, h0)


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 32, 16),
                                   (1, 100, 2, 8, 16, 32),
                                   (2, 144, 2, 16, 32, 128)], ids=str)
def test_mirror_matches_interpret_pallas_kernel(shape, split):
    inp = _inputs(shape, seed_extra=2)
    chunk = shape[-1]
    y, h = ssd_state_passing(*inp, chunk=chunk, split=split)
    yk, hk = jax_ssd_kernel(*[jnp.asarray(t.numpy()) for t in inp],
                            chunk=chunk)
    _within(y, torch.from_numpy(np.array(yk)), 1e-4, 1e-4)
    _within(h, torch.from_numpy(np.array(hk)), 1e-4, 1e-4)


@pytest.mark.parametrize("shape", [(2, 300, 3, 8, 16, 128),
                                   (1, 80, 3, 8, 4, 37)], ids=str)
def test_chunk_cumsums_equal_the_plain_versions_bit_for_bit(shape):
    """The cumsum the kernel takes (and the decays from it) are the plain
    version's and the JAX package's bits: ``chunk_cumsum`` of dt*A and
    ``jnp.cumsum`` over each chunk."""
    B, S, H, P, N, chunk = shape
    inp = _inputs(shape, seed_extra=3)
    x, dt, A = inp[:3]
    _, _, parts = ssd_state_passing(*inp, chunk=chunk, parts=True)
    Q = min(chunk, S)
    pad = (-S) % Q
    dtc = torch.nn.functional.pad(dt, (0, 0, 0, pad)).reshape(B, -1, Q, H)
    dA = dtc * A
    want = chunk_cumsum(dA, dim=2)
    assert torch.equal(parts["cum"], want)
    jax_cum = np.asarray(jnp.cumsum(jnp.asarray(dA.numpy()), axis=2))
    assert np.array_equal(parts["cum"].numpy(), jax_cum)
    cumT = want.permute(0, 1, 3, 2)
    w = dtc.permute(0, 1, 3, 2) * torch.exp(cumT[..., -1:] - cumT)
    assert torch.equal(parts["w"], w)


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
@pytest.mark.parametrize("shape", PADDED, ids=str)
def test_skipping_padded_tiles_keeps_the_bits(shape, split):
    """k-steps past the last chunk's real rows, and chunk 0's C . h_prev,
    add exact zeros: skipping them, as the kernel does, gives the same y
    and h as running them."""
    inp = _inputs(shape, seed_extra=4)
    chunk = shape[-1]
    y, h = ssd_state_passing(*inp, chunk=chunk, split=split)
    y_all, h_all = ssd_state_passing(*inp, chunk=chunk, split=split,
                                     skip_padded=False)
    assert torch.equal(y, y_all) and torch.equal(h, h_all)


def test_state_before_each_chunk_is_the_sequential_recurrence():
    """The state passing's per-chunk states: the state before chunk c is
    the plain one-token recurrence run over the chunks before it."""
    from repro_torch.kernels.ssd import ssd_decode_step
    B, S, H, P, N, chunk = 1, 40, 2, 8, 4, 16
    x, dt, A, Bm, Cm, D = _inputs((B, S, H, P, N, chunk), seed_extra=5)
    _, hT, parts = ssd_state_passing(x, dt, A, Bm, Cm, D, chunk=chunk,
                                     parts=True)
    h = torch.zeros((B, H, N, P))
    for t in range(S):
        if t % chunk == 0:
            _within(parts["states"][:, t // chunk], h, 1e-5, 1e-5)
        _, h = ssd_decode_step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t],
                               D)
    _within(hT, h, 1e-5, 1e-5)


def test_tf32_helpers_are_the_flash_kernels_copies():
    """The SSD package's copies of tf32_round and split_tf32 give the
    flash package's bits on every class of f32 pattern."""
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
    x = torch.where(torch.isnan(x), torch.zeros(()), x)
    assert torch.equal(tf32_round(x), flash_ref.tf32_round(x))
    for a, b in zip(split_tf32(x), flash_ref.split_tf32(x)):
        assert torch.equal(a, b)
