"""The port's drift diagnostics (``repro_torch.core.drift``) against the
JAX package's ``repro.core.drift`` on the same numpy inputs, on the CPU.

The port's ``param_drift`` and ``worker_cka_matrix`` take the port's
worker list (K flat dicts); the JAX functions take the stacked (K, ...)
tree built from the same arrays.  Inputs are float32, made with numpy
from a seed.  Tolerances: the port sums the deltas' Gram matrix in
float64 where JAX sums the flattened deltas in float32, so the
dispersion metrics match to rtol 1e-5 (atol 1e-6 for values near 0); CKA
and subspace overlap to rtol 1e-5."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.core import drift as jdrift
from repro.models.transformer import init_params as jax_init
from repro_torch.core import drift
from repro_torch.models.transformer import forward_hidden
from torch_parity import jax_flat, port_cfg, port_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"embed/table": (11, 6), "layers/w": (2, 5, 3), "norm/scale": (7,)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _workers(rng, g, k, kind="random"):
    """K worker trees around the anchor ``g``: independent deltas, all
    equal, or pairs of opposite deltas."""
    if kind == "identical":
        d = _tree(rng, 0.1)
        return [{n: g[n] + d[n] for n in g} for _ in range(k)]
    if kind == "opposed":
        d = _tree(rng, 0.1)
        return [{n: g[n] + (1 if i % 2 == 0 else -1) * d[n] for n in g}
                for i in range(k)]
    return [{n: g[n] + v for n, v in _tree(rng, 0.1).items()}
            for _ in range(k)]


def _port(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    out = {}
    for path, v in tree.items():
        top, leaf = path.split("/")
        out.setdefault(top, {})[leaf] = jnp.asarray(v)
    return out


def _jax_stacked(workers):
    return _jax({k: np.stack([w[k] for w in workers]) for k in workers[0]})


@pytest.mark.parametrize("k,kind", [(1, "random"), (2, "random"),
                                    (3, "random"), (4, "identical"),
                                    (4, "opposed")])
def test_param_drift_matches_jax(k, kind):
    """Every output of param_drift, K 1 to 4, independent, identical and
    opposed workers (pairwise cosine 1 and -1/3)."""
    rng = np.random.default_rng(k)
    g = _tree(rng)
    ws = _workers(rng, g, k, kind)
    got = drift.param_drift([_port(w) for w in ws], _port(g))
    want = jdrift.param_drift(_jax_stacked(ws), _jax(g))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if kind == "identical":
        assert float(got["pairwise_cos"]) == pytest.approx(1.0, abs=1e-9)
        assert float(got["delta_norm_std"]) == pytest.approx(0.0, abs=1e-9)
    if kind == "opposed":
        # two +d and two -d: pairs (+,+), (-,-) at 1, the other four at -1
        assert float(got["pairwise_cos"]) == pytest.approx(-1 / 3, abs=1e-9)


def test_param_drift_std_has_no_bessel_correction():
    """The ddof trap: jnp.std has ddof 0, torch.std defaults to 1.  Two
    workers whose delta norms differ tell the two apart."""
    rng = np.random.default_rng(7)
    g = _tree(rng)
    d = _tree(rng, 0.1)
    ws = [{n: g[n] + d[n] for n in g}, {n: g[n] + 3 * d[n] for n in g}]
    got = drift.param_drift([_port(w) for w in ws], _port(g))
    want = jdrift.param_drift(_jax_stacked(ws), _jax(g))
    norm = float(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                             for v in d.values())))
    # norms n and 3n: population std n, sample std n * sqrt(2)
    assert float(got["delta_norm_std"]) == pytest.approx(norm, rel=1e-5)
    np.testing.assert_allclose(float(got["delta_norm_std"]),
                               float(want["delta_norm_std"]), rtol=RTOL)


def test_param_drift_slices_give_the_same_gram(monkeypatch):
    """Leaves longer than GRAM_SLICE are summed slice by slice; the
    slices change the float64 Gram matrix by rounding only."""
    rng = np.random.default_rng(3)
    g = _tree(rng)
    ws = [_port(w) for w in _workers(rng, g, 3)]
    whole = drift.delta_gram(ws, _port(g))
    monkeypatch.setattr(drift, "GRAM_SLICE", 4)
    sliced = drift.delta_gram(ws, _port(g))
    assert whole.dtype == sliced.dtype == torch.float64
    torch.testing.assert_close(sliced, whole, rtol=1e-12, atol=1e-14)


def test_delta_cosine_matches_jax():
    rng = np.random.default_rng(11)
    a, b = _tree(rng), _tree(rng)
    got = float(drift.delta_cosine(_port(a), _port(b)))
    want = float(jdrift.delta_cosine(_jax(a), _jax(b)))
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    assert float(drift.delta_cosine(_port(a), _port(a))) == pytest.approx(
        1.0, abs=1e-9)


def _acts(seed, n=64, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("case", ["random", "scaled", "rotated"])
def test_linear_cka_matches_jax(case):
    x = _acts(1)
    y = {"random": _acts(2, d=5), "scaled": -0.2 * x,
         "rotated": x @ np.linalg.qr(_acts(3, 8, 8))[0]}[case]
    got = float(drift.linear_cka(torch.from_numpy(x), torch.from_numpy(y)))
    want = float(jdrift.linear_cka(jnp.asarray(x), jnp.asarray(y)))
    assert got == pytest.approx(want, rel=RTOL)
    if case != "random":
        assert got == pytest.approx(1.0, abs=1e-5)


def _gapped(seed, n=64, d=10, r=4):
    """(n, d) activations whose singular values have a gap after the r-th
    (10, 9, ... above it; 0.1 scale below), so the top-r subspace is
    well defined."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, d)))
    v, _ = np.linalg.qr(rng.standard_normal((d, d)))
    s = np.concatenate([10.0 - np.arange(r), 0.1 * (1 + np.arange(d - r))])
    return (u * s) @ v.T


@pytest.mark.parametrize("r", [1, 4])
def test_subspace_overlap_matches_jax(r):
    x = _gapped(5, r=r)
    y = x + 0.3 * _gapped(6, r=r)
    x, y = x.astype(np.float32), y.astype(np.float32)
    got = float(drift.subspace_overlap(torch.from_numpy(x),
                                       torch.from_numpy(y), r=r))
    want = float(jdrift.subspace_overlap(jnp.asarray(x), jnp.asarray(y),
                                         r=r))
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    assert 0.0 <= got <= 1.0 + 1e-6
    same = float(drift.subspace_overlap(torch.from_numpy(x),
                                        torch.from_numpy(x), r=r))
    assert same == pytest.approx(1.0, abs=1e-5)


def _load_benchmark(name):
    """A script of ``benchmarks/`` as a module (its ``hidden_states``)."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_worker_cka_through_forward_hidden_matches_reference_probe():
    """worker_cka_matrix over three workers' parameters: the port's probe
    (``forward_hidden``, the torch drift benchmark's ``hidden_states``)
    against the JAX benchmark's ``hidden_states`` on the same parameters
    and probe batch (CKA rtol 1e-5, the hidden states atol 1e-5)."""
    cfg = tiny_cfg("dense")
    workers_j = [jax_init(cfg, jax.random.key(s))[0] for s in (0, 1, 2)]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    batch_j = {"tokens": jnp.asarray(toks, jnp.int32)}
    batch_p = {"tokens": torch.from_numpy(toks.astype(np.int32))}
    ref = _load_benchmark("drift_analysis")
    port = _load_benchmark("torch_drift_analysis")
    pcfg = port_cfg(cfg)
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *workers_j)
    want = jdrift.worker_cka_matrix(
        jstack, lambda p, b: ref.hidden_states(p, b, cfg), batch_j)
    flats = [{k: torch.tensor(v) for k, v in jax_flat(w).items()}
             for w in workers_j]
    got = drift.worker_cka_matrix(
        flats, lambda p, b: port.hidden_states(p, b, pcfg), batch_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    h_ref = np.asarray(ref.hidden_states(workers_j[0], batch_j, cfg))
    with torch.no_grad():
        h_port = forward_hidden(port_params(cfg, workers_j[0]), batch_p,
                                pcfg)[0].reshape(-1, cfg.d_model)
    np.testing.assert_allclose(h_port.numpy(), h_ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(h_port, port.hidden_states(flats[0], batch_p, pcfg))
    assert np.allclose(np.diag(got.numpy()), 1.0, atol=1e-5)
