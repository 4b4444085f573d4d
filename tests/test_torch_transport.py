"""The port's outer-sync wire against the JAX package, on the CPU: the
plain quantize / dequantize (the CPU path of the CUDA kernels), every
codec, drift-aware averaging, the outer step with a residual, fragments,
and the payload schedules.

Inputs are made with numpy from a seed and handed to both packages.  The
port follows the reference's oracle (``reference_quantize_ef``: the scale
a true division by QMAX, the residual a product and a difference each
rounded), bit for bit.  The JAX package's Pallas kernel in interpret mode
departs from that oracle on the CPU: XLA turns its ``amax / QMAX`` into a
product with 1/QMAX (one ulp off in about half the rows) and contracts
``e - q * scale`` into an FMA; so against the interpret-mode kernel the
codes are compared bit for bit and the scales and residuals within those
roundings.  The JAX codecs are taken on their oracle path
(``use_kernel=False``) where bit equality is the point."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs.base import DiLoCoConfig as JaxDiLoCoConfig
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig
from repro.core import outer_opt as jax_outer_opt
from repro.core import sync as jax_sync
from repro.core import transport as jax_transport
from repro.core.diloco import DiLoCoTrainer as JaxDiLoCoTrainer
from repro.core.streaming import StreamingDiLoCoTrainer as JaxStreamingTrainer
from repro.core.streaming import fragment_masks as jax_fragment_masks
from repro.kernels.quantize import dequantize as jax_dequantize
from repro.kernels.quantize import quantize_ef as jax_quantize_ef
from repro.kernels.quantize.ref import reference_dequantize as jax_ref_dq
from repro.kernels.quantize.ref import reference_quantize_ef as jax_ref_qef
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import DiLoCoConfig, OptimizerConfig
from repro_torch.core import outer_opt, sync, transport
from repro_torch.core.streaming import StreamingDiLoCoTrainer, fragment_masks
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.quantize import dequantize, quantize_ef
from repro_torch.models.transformer import flatten
from torch_parity import jax_flat, port_params

torch.set_num_threads(1)

QDTYPES = ("int8", "fp8_e4m3", "fp8_e5m2")
SHAPES = [(2, 128), (3, 5, 7), (1, 100), (4,), (), (2, 0)]
CODECS = ("f32", "bf16", "int8", "fp8", "fp8_e5m2")


def _bits(a) -> np.ndarray:
    """Raw bytes of a jax / numpy array or a torch tensor, any dtype."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            a = a.view(torch.uint8)
        elif a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def _same(a, b, what=""):
    assert tuple(np.shape(np.asarray(a))) == tuple(b.shape), what
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _inputs(shape, seed=0, residual=True):
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal(shape) * 3, dtype=np.float32)
    r = (np.asarray(rng.standard_normal(shape) * 0.01, dtype=np.float32)
         if residual else None)
    return x, r


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# quantize_ef / dequantize: the CPU path of the CUDA kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_ef_equals_reference_oracle_bit_for_bit(dtype, shape,
                                                         residual):
    """Payload bytes, residual and scales (values and shapes) equal the
    JAX oracle's bit for bit, with and without a residual, on rows, 3-d,
    1-d, scalar and 0-size leaves; the launch counter stays at 0 on the
    CPU; dequantize equals the oracle's."""
    x, r = _inputs(shape, residual=residual)
    want = jax_ref_qef(_j(x), _j(r), dtype=dtype)
    reset_launches()
    got = quantize_ef(_t(x), _t(r), dtype=dtype)
    for a, b, what in zip(want, got, ("q", "residual", "scale")):
        _same(a, b, what)
    _same(jax_ref_dq(want[0], want[2]), dequantize(got[0], got[2]),
          "dequantize")
    assert launches["quantize_ef"] == launches["dequantize"] == 0


@pytest.mark.parametrize("tile", [0, 128, 256])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_ef_tracks_interpret_mode_pallas_kernel(dtype, shape, tile):
    """Against the interpret-mode Pallas kernel, per row and per tile
    (tile 128 and 256: scales over the zero-padded layout, shaped (K,
    padded_M // tile)): codes bit for bit; scales within one ulp (the
    kernel's reciprocal product); residuals within the FMA's rounding;
    dequantize bit for bit on the kernel's own payload and scales."""
    x, r = _inputs(shape, seed=1)
    want = jax_quantize_ef(_j(x), _j(r), dtype=dtype, tile=tile)
    got = quantize_ef(_t(x), _t(r), dtype=dtype, tile=tile)
    _same(want[0], got[0], "q")
    for a, b in ((want[1], got[1]), (want[2], got[2])):
        assert tuple(np.shape(a)) == tuple(b.shape)
    e = np.abs(x + r).max() if x.size else 0.0
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=2.0 ** -21 * e)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2.0 ** -23, atol=0)
    jq = torch.from_numpy(np.asarray(want[0]).view(np.uint8).copy()).view(
        got[0].dtype) if dtype != "int8" else torch.from_numpy(
            np.asarray(want[0]).copy())
    _same(jax_dequantize(want[0], want[2], tile=tile),
          dequantize(jq, torch.from_numpy(np.asarray(want[2]).copy()),
                     tile=tile), "dequantize")


def test_quantize_clips_before_the_cast_and_rounds_half_to_even():
    """Ties of e / scale round to even for int8, a row at ±amax maps to
    ±QMAX, and an all-zero row gets the 1e-12 / QMAX scale and zero codes,
    as the oracle does."""
    x = np.array([[127.0, -63.5, 0.5, 1.5, 2.5, -0.5],
                  [0.0] * 6], np.float32)
    for dtype in QDTYPES:
        want = jax_ref_qef(jnp.asarray(x), None, dtype=dtype)
        got = quantize_ef(torch.from_numpy(x), dtype=dtype)
        for a, b in zip(want, got):
            _same(a, b, dtype)
    q = quantize_ef(torch.from_numpy(x), dtype="int8")[0]
    assert q[0].tolist() == [127, -64, 0, 2, 2, 0] and not q[1].any()


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_ef_propagates_nan_and_inf_like_the_oracle(dtype):
    """A NaN (or an inf) in a row makes that row's scale NaN (inf) and its
    residuals and decoded values NaN, as the JAX oracle does: a diverged
    worker ships no valid-looking payload.  The finite row is bit for
    bit."""
    x, r = _inputs((3, 50), seed=4)
    x[1, 17] = np.nan
    x[2, 3] = np.inf
    want = jax_ref_qef(jnp.asarray(x), jnp.asarray(r), dtype=dtype)
    got = quantize_ef(_t(x), _t(r), dtype=dtype)
    for a, b in ((want[1], got[1]), (want[2], got[2]),
                 (jax_ref_dq(want[0], want[2]), dequantize(got[0], got[2]))):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))
    assert got[2][1].isnan().all() and got[2][2].isinf().all()
    assert got[1][1:].isnan().all()
    _same(want[0][0], got[0][0], dtype)


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

def _tree(seed=0, k=2):
    """A stacked (K, ...) delta tree with a 3-d, a stacked-scalar and a
    0-size leaf, and its residual."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (k, 3, 5), "b": (k,), "c": (k, 4, 33), "z": (k, 0)}
    d = {n: np.asarray(rng.standard_normal(s) * 0.02, np.float32)
         for n, s in shapes.items()}
    r = {n: np.asarray(rng.standard_normal(s) * 1e-4, np.float32)
         for n, s in shapes.items()}
    return d, r


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("name", CODECS)
def test_codecs_match_jax_codecs(name, residual):
    """encode (payload bytes, scales, residual), decode, nbytes,
    schedule_bytes, width, lossy and name equal the JAX codec's (oracle
    path) for every codec, with and without an error-feedback residual."""
    d, r = _tree()
    jc = jax_transport.make_codec(name, use_kernel=False)
    pc = transport.make_codec(name)
    assert (pc.name, pc.width, pc.lossy) == (jc.name, jc.width, jc.lossy)
    assert pc.schedule_bytes(1000) == jc.schedule_bytes(1000)
    jp, jr = jc.encode({k: jnp.asarray(v) for k, v in d.items()},
                       {k: jnp.asarray(v) for k, v in r.items()}
                       if residual else None)
    pp, pr = pc.encode({k: torch.from_numpy(v) for k, v in d.items()},
                       {k: torch.from_numpy(v) for k, v in r.items()}
                       if residual else None)
    assert (pp.codec, pp.kind, pp.fragment) == (jp.codec, jp.kind,
                                                jp.fragment)
    assert pp.nbytes() == jp.nbytes()
    for k in d:
        _same(jp.data[k], pp.data[k], f"data {k}")
        if jp.scales is None:
            assert pp.scales is None
        else:
            _same(jp.scales[k], pp.scales[k], f"scale {k}")
        if residual:
            _same(jr[k], pr[k], f"residual {k}")
    assert (pr is None) == (not residual)
    jd, pd = jc.decode(jp), pc.decode(pp)
    for k in d:
        _same(jd[k], pd[k], f"decode {k}")


@pytest.mark.parametrize("name", ["bf16", "int8", "fp8", "fp8_e5m2"])
def test_error_feedback_residual_is_the_round_trip_error(name):
    """new residual == (delta + residual) - decode(payload), bit for bit:
    every bit that fails to cross the wire is carried to the next round."""
    d, r = _tree(seed=3)
    codec = transport.make_codec(name)
    dt = {k: torch.from_numpy(v) for k, v in d.items()}
    rt = {k: torch.from_numpy(v) for k, v in r.items()}
    payload, nr = codec.encode(dt, rt)
    dq = codec.decode(payload)
    for k in d:
        assert torch.equal(nr[k], (dt[k] + rt[k]) - dq[k]), k
    assert codec.lossy


def test_make_codec_aliases_and_unknown_names():
    for alias in jax_transport._ALIASES:
        jc = jax_transport.make_codec(alias)
        assert transport.make_codec(alias).name == jc.name, alias
        assert transport.wire_width(alias) == jax_transport.wire_width(alias)
    assert outer_opt.DELTA_WIDTH == jax_outer_opt.DELTA_WIDTH
    with pytest.raises(ValueError, match="unknown delta dtype"):
        transport.make_codec("int4")


def test_transport_counts_shipped_wire_bytes():
    d, r = _tree()
    t = transport.Transport(transport.make_codec("int8"))
    transport.reset_shipped()
    out, nr = t.exchange({k: torch.from_numpy(v) for k, v in d.items()},
                         {k: torch.from_numpy(v) for k, v in r.items()})
    n = sum(v.size for v in d.values())
    assert transport.shipped == {"int8": n + 4 * 2 * len(d)}
    assert set(out) == set(nr) == set(d)


def test_quantize_delta_round_trip_matches_jax():
    d, _ = _tree(seed=5)
    for name in ("float32", "int8", "fp8", "fp8_e5m2"):
        jp, js = jax_outer_opt.quantize_delta(
            {k: jnp.asarray(v) for k, v in d.items()}, name)
        pp, ps = outer_opt.quantize_delta(
            {k: torch.from_numpy(v) for k, v in d.items()}, name)
        jd = jax_outer_opt.dequantize_delta(jp, js)
        pd = outer_opt.dequantize_delta(pp, ps)
        for k in d:
            _same(jp[k], pp[k], f"{name} {k}")
            _same(jd[k], pd[k], f"{name} dequant {k}")


# ---------------------------------------------------------------------------
# Averaging and the outer step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("drift_aware", [False, True])
def test_average_matches_jax(k, drift_aware):
    """The plain mean (bit for bit at K 2, where both sum the two rows)
    and the drift-aware cosine-softmax weighting (within 1e-6) over a
    decoded (K, ...) tree."""
    d, _ = _tree(seed=7, k=k)
    jcfg = JaxDiLoCoConfig(drift_aware=drift_aware)
    want = jax_outer_opt._average({n: jnp.asarray(v) for n, v in d.items()},
                                  jcfg)
    got = outer_opt._average({n: torch.from_numpy(v) for n, v in d.items()},
                             DiLoCoConfig(drift_aware=drift_aware))
    for n in d:
        if k == 2 and not drift_aware:
            _same(want[n], got[n], n)
        else:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                       atol=1e-6, rtol=0, err_msg=n)


@pytest.fixture(scope="module")
def jparams():
    return jax_init(tiny_cfg("dense"), jax.random.key(0))[0]


def _jax_like(tree, flat):
    return jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat["/".join(str(q.key) for q in p)]),
        tree)


def _outer_states(jparams, dcfg_kw, streaming=False, seed=11):
    """A K=2 DiLoCo state after some imagined inner steps (workers = params
    + seeded noise, seeded momentum) and a seeded residual, in both
    packages; the JAX trainer takes its oracle codec path (an identity
    replicate hop), the one its bit-exactness is defined by."""
    rng = np.random.default_rng(seed)
    flat = jax_flat(jparams)
    noise = {k: np.asarray(rng.standard_normal((2,) + v.shape) * 3e-3,
                           np.float32) for k, v in flat.items()}
    mom = {k: np.asarray(rng.standard_normal(v.shape) * 1e-3, np.float32)
           for k, v in flat.items()}
    res = {k: np.asarray(rng.standard_normal((2,) + v.shape) * 1e-5,
                         np.float32) for k, v in flat.items()}
    opt = dict(total_steps=4, warmup_steps=1)
    jcls, pcls = ((JaxStreamingTrainer, StreamingDiLoCoTrainer) if streaming
                  else (JaxDiLoCoTrainer, StreamingDiLoCoTrainer))
    jt = jcls(None, JaxOptimizerConfig(**opt),
              JaxDiLoCoConfig(num_workers=2, **dcfg_kw),
              replicate_fn=lambda t: t)
    js = jt.init(jparams)
    js = js._replace(
        worker_params=_jax_like(jparams, {k: flat[k][None] + noise[k]
                                          for k in flat}),
        outer=js.outer._replace(v=_jax_like(jparams, mom)))
    pt = pcls(None, OptimizerConfig(**opt),
              DiLoCoConfig(num_workers=2, **dcfg_kw))
    ps = pt.init(port_params(tiny_cfg("dense"), jparams))
    with torch.no_grad():
        for i, w in enumerate(ps.worker_params):
            for k, t in w.items():
                t.copy_(torch.from_numpy(flat[k] + noise[k][i]))
        for k, t in ps.outer.v.items():
            t.copy_(torch.from_numpy(mom[k]))
    jres = _jax_like(jparams, res) if jt.init_residual(jparams) else None
    pres = ({k: torch.from_numpy(v.copy()) for k, v in res.items()}
            if pt.init_residual(ps.global_params) is not None else None)
    return jt, js, jres, pt, ps, pres


def _close_state(js, jres, ps, pres, atol=1e-6):
    for name, want, got in (("params", jax_flat(js.global_params),
                             ps.global_params),
                            ("momentum", jax_flat(js.outer.v), ps.outer.v)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol,
                                       rtol=0, err_msg=f"{name} {k}")
    jw = jax_flat(js.worker_params)
    for i, w in enumerate(ps.worker_params):
        for k in jw:
            np.testing.assert_allclose(w[k].numpy(), jw[k][i], atol=atol,
                                       rtol=0, err_msg=f"worker {i} {k}")
    assert (jres is None) == (pres is None)
    if pres is not None:
        for k, v in jax_flat(jres).items():
            np.testing.assert_allclose(pres[k].numpy(), v, atol=atol, rtol=0,
                                       err_msg=f"residual {k}")
    assert int(ps.outer.t) == int(js.outer.t)


@pytest.mark.parametrize("codec", ["int8", "fp8", "fp8_e5m2", "bfloat16"])
def test_outer_step_ef_matches_jax(jparams, codec):
    """The port's leaf-by-leaf outer_step_ef against JAX's whole-tree one
    from the same K=2 state and residual: the deltas encode to the same
    codes and scales bit for bit, and the new anchor, momentum, workers
    and residual agree within 1e-6."""
    jt, js, jres, pt, ps, pres = _outer_states(jparams,
                                               {"delta_dtype": codec})
    jdelta = jax.tree.map(lambda w, g: w - g[None], js.worker_params,
                          js.global_params)
    pdelta = {k: outer_opt.stack_delta([w[k] for w in ps.worker_params], g)
              for k, g in ps.global_params.items()}
    jp, _ = jax_transport.make_codec(codec, use_kernel=False).encode(
        jdelta, jres)
    pp, _ = transport.make_codec(codec).encode(pdelta, pres)
    for k, v in jax_flat(jp.data).items():
        _same(v, pp.data[k], f"codes {k}")
    if jp.scales is not None:
        for k, v in jax_flat(jp.scales).items():
            _same(v, pp.scales[k], f"scales {k}")
    js, jres = jt.outer_step_ef(js, jres)
    ps, pres = pt.outer_step_ef(ps, pres)
    _close_state(js, jres, ps, pres)


@pytest.mark.parametrize("frag", [0, 1])
def test_fragment_outer_step_matches_jax_masked_step(jparams, frag):
    """A fragment sync on layer slices equals the reference's masked
    whole-tree sync (int8 wire, residual): synced slots, untouched slots,
    the momentum decaying outside the fragment, the residual merged."""
    jt, js, jres, pt, ps, pres = _outer_states(
        jparams, {"delta_dtype": "int8"}, streaming=True)
    jmask = jax_fragment_masks(jparams, 2)[frag]
    js, jres = jt.outer_step_fragment_ef(js, jmask, jres)
    ps, pres = pt.outer_step_fragment_ef(
        ps, fragment_masks(ps.global_params, 2)[frag], pres)
    _close_state(js, jres, ps, pres)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_masked_fragment_quantizes_like_its_layer_slice(dtype):
    """Quantizing a stacked (K, L, ...) leaf with zeros outside layers
    [lo, hi) (the reference's mask) and quantizing only the slice give
    the same codes, scales and in-slice residual bit for bit; outside the
    slice the masked codes are 0 and the residual the masked zeros."""
    rng = np.random.default_rng(9)
    x = np.asarray(rng.standard_normal((2, 5, 6, 7)), np.float32)
    r = np.asarray(rng.standard_normal((2, 5, 6, 7)) * 1e-3, np.float32)
    lo, hi = 1, 3
    m = np.zeros((1, 5, 1, 1), np.float32)
    m[:, lo:hi] = 1
    want = jax_ref_qef(jnp.asarray(x * m), jnp.asarray(r * m), dtype=dtype)
    got = quantize_ef(torch.from_numpy(x[:, lo:hi].copy()),
                      torch.from_numpy(r[:, lo:hi].copy()), dtype=dtype)
    _same(np.asarray(want[0])[:, lo:hi], got[0], "codes")
    _same(np.asarray(want[1])[:, lo:hi], got[1], "residual")
    _same(want[2], got[2], "scales")
    assert not np.asarray(want[0]).astype(np.float32)[:, :lo].any()
    assert not np.asarray(want[1])[:, hi:].any()


@pytest.mark.parametrize("f", [1, 2, 3])
def test_fragment_masks_match_jax(jparams, f):
    """Each fragment's layer ranges (and owners of the unstacked leaves)
    select exactly the reference's masks, also with more fragments than
    layers (empty ranges)."""
    want = jax_fragment_masks(jparams, f)
    params = flatten(port_params(tiny_cfg("dense"), jparams))
    got = fragment_masks(params, f)
    assert len(got) == f
    for jm, pm in zip(want, got):
        for k, m in jax_flat(jm).items():
            mine = np.zeros(m.shape, bool)
            if pm[k] is not None:
                mine[pm[k]] = True
            np.testing.assert_array_equal(mine, m, err_msg=k)
        assert sum(params[k][sl].numel() for k, sl in pm.items()
                   if sl is not None) == sum(
            int(m.sum()) for m in jax_flat(jm).values())


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 8])
def test_hop_bytes_per_worker_matches_jax(k):
    for coll in ("gather", "reduce", "peer"):
        assert (sync.hop_bytes_per_worker(1000, k, coll)
                == jax_sync.hop_bytes_per_worker(1000, k, coll))
    with pytest.raises(ValueError):
        sync.hop_bytes_per_worker(1, k, "broadcast")


def _pairs():
    return [("ddp", sync.DDPSync(), jax_sync.DDPSync()),
            ("ddp_compressed", sync.CompressedDDPSync(),
             jax_sync.CompressedDDPSync()),
            ("diloco", sync.DiLoCoSync(), jax_sync.DiLoCoSync()),
            ("streaming", sync.StreamingSync(num_fragments=3),
             jax_sync.StreamingSync(num_fragments=3)),
            ("overlapped", sync.OverlappedSync(delay=2, jitter=1),
             jax_sync.OverlappedSync(delay=2, jitter=1)),
            ("pipelined", sync.PipelinedSync(num_fragments=4, delay=3),
             jax_sync.PipelinedSync(num_fragments=4, delay=3))]


@pytest.mark.parametrize("codec", ["float32", "bfloat16", "int8", "fp8",
                                   "fp8_e5m2"])
@pytest.mark.parametrize("name,ours,ref", _pairs(), ids=lambda x: (
    x if isinstance(x, str) else ""))
def test_payload_schedules_match_jax(name, ours, ref, codec):
    """Every ported strategy's host-side schedule equals the reference's
    event for event (step, bytes per worker, kind, apply step, fragment,
    codec)."""
    kw = dict(num_workers=4, h_inner_steps=8, delta_dtype=codec,
              grad_compress="int8" if codec == "int8" else "none",
              strategy=name)
    got = ours.payload_schedule(1_000_003, 40, DiLoCoConfig(**kw))
    want = ref.payload_schedule(1_000_003, 40, JaxDiLoCoConfig(**kw))
    assert [dataclasses.astuple(e) for e in got] == [
        dataclasses.astuple(e) for e in want]


def test_codec_aware_payload_schedule_ratios():
    """The reference's byte-ratio pins (tests/test_transport.py): int8
    pipelined fragments ship >= 8x fewer bytes than f32 DiLoCo, bf16 half
    of f32, fragment ids rotate, and fp8 at 2F halves int8 at F."""
    n, steps, h = 1_000_000, 400, 100
    cfg = lambda dt: DiLoCoConfig(h_inner_steps=h, delta_dtype=dt)
    total = lambda ev: sum(e.bytes_per_worker for e in ev)
    base = total(sync.DiLoCoSync().payload_schedule(n, steps, cfg("float32")))
    events = sync.PipelinedSync(num_fragments=4, delay=h // 2
                                ).payload_schedule(n, steps, cfg("int8"))
    assert all(e.codec == "int8" and e.kind == "fragment" for e in events)
    assert all(e.apply_step - e.step == h // 2 for e in events)
    assert base / total(events) >= 8
    assert total(sync.DiLoCoSync().payload_schedule(
        n, steps, cfg("bfloat16"))) * 2 == base
    assert [e.fragment for e in events] == [0, 1, 2, 3]
    f8 = sync.PipelinedSync(num_fragments=8, delay=h // 2).payload_schedule(
        n, steps, cfg("fp8"))
    assert total(events) == 2 * total(f8)


def test_fp8_and_int8_scales_ride_the_reference_nbytes():
    """OuterPayload.nbytes of a K=1 payload of the tiny model: the f32
    wire is 4 bytes per parameter, int8 and fp8 one byte per parameter
    plus 4 scale bytes per leaf, as the reference counts them."""
    params = {k: v[None] for k, v in flatten(port_params(
        tiny_cfg("dense"), jax_init(tiny_cfg("dense"),
                                    jax.random.key(0))[0])).items()}
    n = sum(v.numel() for v in params.values())
    for name, want in (("f32", 4 * n), ("int8", n + 4 * len(params)),
                       ("fp8", n + 4 * len(params))):
        payload, _ = transport.make_codec(name).encode(params)
        assert payload.nbytes() == want, name
