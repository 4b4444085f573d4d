"""The RMSNorm kernels' layout and summation order, on the CPU.

The CUDA kernels (``csrc/rmsnorm.cu``) keep a row in registers: the
threads that share a row (one warp up to 2048, a CTA of 256 above) take
its 16-byte vectors in turn, ``tile`` of them each, and ``ops.layout``
picks both from d and the dtype alone, so a row's bits never depend on
the rows launched with it.  These tests hold that choice to every width
the repository's configs use, to the tiles the source instantiates, and
hold a plain-torch model of the kernels' summation order (each thread's
vector components over its tiles, the components pairwise, the warp's
xor butterfly, the warps in order; the backward's dscale through the
groups' partials and the column sum) to the JAX oracle and ``jax.vjp``
within the f32 tolerances of the card's gates."""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.kernels.rmsnorm import (reference_rmsnorm,
                                   reference_rmsnorm_residual)
from repro_torch.configs import registry as torch_registry
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import ops

torch.set_num_threads(1)

# partial rows one column-sum thread walks (csrc/rmsnorm.cu kColRows)
COL_ROWS = int(re.search(r"kColRows = (\d+);",
                         (_build.CSRC / "rmsnorm.cu").read_text()).group(1))

O_TOL = (1e-5, 1e-4)        # (atol, rtol): chip_smoke's f32 forward gate
DSCALE_TOL = (1e-3, 1e-4)   # chip_smoke's dscale gate (a sum over rows)
DTYPES = (torch.float32, torch.bfloat16)


def _config_widths():
    """{d_model: [config names]} over the JAX package's configs and the
    port's, full and reduced."""
    widths = {}
    for reg in (jax_registry, torch_registry):
        for arch in reg.ALL_IDS:
            for kind, get in (("", reg.get_config),
                              (" reduced", reg.get_reduced)):
                widths.setdefault(get(arch).d_model, []).append(arch + kind)
    return widths


CONFIG_WIDTHS = _config_widths()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", sorted(CONFIG_WIDTHS))
def test_layout_takes_every_config_width(d, dtype):
    threads, tile = ops.layout(d, dtype)
    per_vector = 16 // dtype.itemsize
    assert threads == (32 if d <= ops.WARP_MAX_D else ops.CTA_THREADS)
    assert tile in ops.TILES[threads, dtype]
    assert threads * tile * per_vector >= d, CONFIG_WIDTHS[d]


def test_config_widths_include_the_port_and_jax_model_widths():
    assert {1024, 1280, 1600, 2048, 4096, 5120, 6144,
            12288} <= set(CONFIG_WIDTHS)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layout_covers_every_multiple_of_8_with_the_smallest_tile(dtype):
    per_vector = 16 // dtype.itemsize
    for d in range(8, ops.MAX_D + 1, 8):
        threads, tile = ops.layout(d, dtype)
        tiles = ops.TILES[threads, dtype]
        assert threads * tile * per_vector >= d
        smaller = [t for t in tiles if t < tile]
        assert not smaller or threads * max(smaller) * per_vector < d


@pytest.mark.parametrize("d", [0, -8, 4, 12, 1284, ops.MAX_D + 8, 16384])
def test_layout_refuses_what_the_kernels_do_not_take(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.layout(d, torch.float32)


def test_layout_refuses_other_dtypes_and_never_takes_the_row_count():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.layout(1280, torch.float16)
    assert list(inspect.signature(ops.layout).parameters) == ["d", "dtype"]


def test_tiles_are_the_ones_the_source_instantiates():
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    names = {(32, torch.float32): "TILES_WARP_F32",
             (32, torch.bfloat16): "TILES_WARP_BF16",
             (ops.CTA_THREADS, torch.float32): "TILES_CTA_F32",
             (ops.CTA_THREADS, torch.bfloat16): "TILES_CTA_BF16"}
    assert set(names) == set(ops.TILES)
    for key, name in names.items():
        line = re.search(rf"#define {name}\(X\)(.*)", src).group(1)
        assert tuple(int(n) for n in re.findall(r"X\((\d+)\)", line)) == \
            ops.TILES[key]
    assert re.search(rf"kCtaThreads = {ops.CTA_THREADS};", src)
    assert re.search(rf"kBwdThreads = {ops._BWD_THREADS};", src)


# ---------------------------------------------------------------------------
# A plain-torch model of the kernels' summation order (f32)
# ---------------------------------------------------------------------------

def _thread_sums(a):
    """(rows, d) f32 -> (rows, threads) f32: each thread's partial of the
    row as the kernels take it: vector j = v * threads + t of ``tile``,
    each component summed over v in order, then the components
    pairwise."""
    rows, d = a.shape
    threads, tile = ops.layout(d, torch.float32)
    per_vector = 4
    padded = torch.zeros((rows, tile * threads * per_vector))
    padded[:, :d] = a
    blocks = padded.view(rows, tile, threads, per_vector)
    p = torch.zeros((rows, threads, per_vector))
    for v in range(tile):
        p = p + blocks[:, v]
    w = 1
    while w < per_vector:
        p = p.clone()
        for i in range(0, per_vector - w, 2 * w):
            p[..., i] = p[..., i] + p[..., i + w]
        w *= 2
    return p[..., 0]


def _group_sum(t):
    """(rows, threads) -> (rows,): the xor butterfly in each warp (every
    lane ends with the same bits), then the warps in order."""
    rows, threads = t.shape
    lanes = torch.arange(32)
    w = t.reshape(rows, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lanes ^ o]
    assert torch.equal(w, w[..., :1].expand_as(w))
    total = w[:, 0, 0]
    for k in range(1, threads // 32):
        total = total + w[:, k, 0]
    return total


def _kernel_order_fwd(x, scale, eps=1e-5, residual=None):
    s = x if residual is None else x + residual
    d = s.shape[-1]
    inv = torch.rsqrt(_group_sum(_thread_sums(s * s)) / d + eps)
    return (s * inv[:, None]) * scale


def _kernel_order_bwd(dy, x, scale, eps=1e-5, residual=None, dh=None,
                      ctas=132):
    """dx and dscale as the backward kernel sums them, on ``ctas``
    persistent CTAs of 256 threads (8 warp-wide rows at once to d 2048,
    one CTA-wide row above), each group's dscale partial over its rows in
    walk order, the groups in order, the CTAs' rows by the column sum's
    fixed order (rows y, y + COL_ROWS, ... then the COL_ROWS sums in y
    order)."""
    s = x if residual is None else x + residual
    rows, d = s.shape
    threads, _ = ops.layout(d, torch.float32)
    g = dy * scale
    ss = _group_sum(_thread_sums(s * s))
    gs = _group_sum(_thread_sums(g * s))
    inv = torch.rsqrt(ss / d + eps)
    c = inv * inv * inv * (gs / d)
    dx = inv[:, None] * g - c[:, None] * s
    if dh is not None:
        dx = dx + dh
    contrib = dy * s * inv[:, None]
    groups = ops._BWD_THREADS // threads
    ctas = min(ctas, -(-rows // groups))
    partial = torch.zeros((ctas, d))
    for cta in range(ctas):
        acc = torch.zeros((groups, d))
        for grp in range(groups):
            for r in range(cta * groups + grp, rows, ctas * groups):
                acc[grp] = acc[grp] + contrib[r]
        total = acc[0]
        for grp in range(1, groups):
            total = total + acc[grp]
        partial[cta] = total
    part = torch.zeros((COL_ROWS, d))
    for y in range(COL_ROWS):
        for b in range(y, ctas, COL_ROWS):
            part[y] = part[y] + partial[b]
    dscale = part[0]
    for y in range(1, COL_ROWS):
        dscale = dscale + part[y]
    return dx, dscale


def _inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    x, r, dy, dh = ((2 * rng.standard_normal((rows, d))).astype(np.float32)
                    for _ in range(4))
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, r, dy, dh, s


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol[0],
                               rtol=tol[1])


@pytest.mark.parametrize("d", [1280, 2048, 12288])
def test_kernel_order_forward_matches_the_jax_oracle(d):
    x, r, _, _, s = _inputs(6, d, d)
    t = torch.from_numpy
    _close(_kernel_order_fwd(t(x), t(s)),
           reference_rmsnorm(jnp.asarray(x), jnp.asarray(s)), O_TOL)
    want, _ = reference_rmsnorm_residual(jnp.asarray(x), jnp.asarray(r),
                                         jnp.asarray(s))
    _close(_kernel_order_fwd(t(x), t(s), residual=t(r)), want, O_TOL)


@pytest.mark.parametrize("d", [1280, 2048, 12288])
@pytest.mark.parametrize("residual", [False, True])
def test_kernel_order_backward_matches_jax_vjp(d, residual):
    rows = 40 if d <= ops.WARP_MAX_D else 12
    x, r, dy, dh, s = _inputs(rows, d, d + residual)
    t = torch.from_numpy
    if residual:
        _, vjp = jax.vjp(reference_rmsnorm_residual, *(jnp.asarray(a)
                                                       for a in (x, r, s)))
        jdx, _, jds = vjp((jnp.asarray(dy), jnp.asarray(dh)))
        dx, ds = _kernel_order_bwd(t(dy), t(x), t(s), residual=t(r),
                                   dh=t(dh), ctas=3)
    else:
        _, vjp = jax.vjp(reference_rmsnorm, jnp.asarray(x), jnp.asarray(s))
        jdx, jds = vjp(jnp.asarray(dy))
        dx, ds = _kernel_order_bwd(t(dy), t(x), t(s), ctas=3)
    _close(dx, jdx, O_TOL)
    _close(ds, jds, DSCALE_TOL)


def test_kernel_order_rows_do_not_depend_on_the_launch():
    """The model's row bits are the same whether a row is normalised with
    39 others or alone: nothing in the order depends on the row count."""
    x, r, _, _, s = _inputs(40, 1280, 5)
    t = torch.from_numpy
    whole = _kernel_order_fwd(t(x), t(s), residual=t(r))
    alone = torch.cat([_kernel_order_fwd(t(x[i:i + 1]), t(s),
                                         residual=t(r[i:i + 1]))
                       for i in range(40)])
    assert torch.equal(whole, alone)
