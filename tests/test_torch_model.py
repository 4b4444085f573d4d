"""The port's model and checkpoint modules against the JAX package: the
same parameters (converted through ``params_from_numpy``) and the same
numpy inputs give the same logits and the same updated KV pool from
``decode_step_paged`` / ``verify_step_paged`` (f32, atol 1e-4 on logits of
live rows), with ragged tables, unmapped (-1) blocks and inactive slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.checkpoint import save_config, save_pytree
from repro.configs.nanochat_d20 import CONFIG as JAX_D20
from repro.models.transformer import abstract_params, build_model
from repro.models.transformer import init_params as jax_init_params
from repro_torch.checkpoint import (load_config, load_pytree,
                                    params_from_numpy)
from repro_torch.configs import NANOCHAT_D20
from repro_torch.models import (decode_step_paged, init_paged_cache,
                                init_params, paged_block_bytes,
                                param_shapes, verify_step_paged)
from repro_torch.models.attention import paged_inputs, scatter_plan
from repro_torch.models.transformer import flatten
from torch_cases import paged_tables
from torch_parity import jax_flat, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg("dense")
    params, _ = jax_init_params(cfg, jax.random.key(0))
    return cfg, build_model(cfg), params, port_params(cfg, params)


# ---------------------------------------------------------------------------
# Configs, parameter trees, checkpoints
# ---------------------------------------------------------------------------

def test_nanochat_d20_config_matches_reference():
    assert port_cfg(JAX_D20) == NANOCHAT_D20
    assert NANOCHAT_D20.param_count() == JAX_D20.param_count() == 692112640


@pytest.mark.parametrize("cfg", [tiny_cfg("dense"), JAX_D20,
                                 tiny_cfg("dense", tie_embeddings=False,
                                          qkv_bias=True)],
                         ids=["tiny", "nanochat-d20", "untied-bias"])
def test_param_shapes_match_the_jax_tree(cfg):
    """Same leaf paths and shapes as the JAX package's parameter tree, so
    checkpoints map one to one (d20 is traced abstractly: no weights)."""
    sds, _ = abstract_params(cfg)
    want = {k: tuple(v.shape) for k, v in jax_flat_shapes(sds).items()}
    assert param_shapes(port_cfg(cfg)) == want


def jax_flat_shapes(tree):
    from repro.checkpoint.checkpoint import _path_str
    return {_path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_checkpoint_loads_without_jax(tiny, tmp_path):
    cfg, _, params, _ = tiny
    path = str(tmp_path / "ckpt")
    save_pytree(params, path)
    save_config(cfg, path)
    pcfg = load_config(path)
    assert pcfg == port_cfg(cfg)
    flat = load_pytree(path)
    assert sorted(flat) == sorted(jax_flat(params))
    got = flatten(params_from_numpy(flat, pcfg, "cpu"))
    for k, v in jax_flat(params).items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert load_config(str(tmp_path / "missing")) is None


def test_params_from_numpy_refuses_mismatches(tiny):
    cfg, _, params, _ = tiny
    flat = jax_flat(params)
    pcfg = port_cfg(cfg)
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "layers/attn/wq"}, pcfg)
    with pytest.raises(KeyError, match="unexpected"):
        params_from_numpy(dict(flat, extra=np.zeros(3)), pcfg)
    bad = dict(flat)
    bad["layers/mlp/w_up"] = bad["layers/mlp/w_up"][:, :, :-1]
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_numpy(bad, pcfg)


def test_init_params_is_seeded_and_shaped():
    cfg = port_cfg(tiny_cfg("dense", tie_embeddings=False))
    a, b = flatten(init_params(cfg, seed=3)), flatten(init_params(cfg, seed=3))
    c = flatten(init_params(cfg, seed=4))
    assert {k: tuple(v.shape) for k, v in a.items()} == param_shapes(cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers/attn/wq"], c["layers/attn/wq"])
    assert torch.equal(a["layers/ln1/scale"], torch.ones(2, 64))
    # truncated-normal fan-in init: |w| <= 3 / sqrt(fan_in)
    assert float(a["layers/attn/wq"].abs().max()) <= 3 / 8 + 1e-6
    assert sum(v.numel() for v in a.values()) == cfg.param_count()


def test_paged_block_bytes_and_pool_match_reference():
    cfg = tiny_cfg("dense")
    from repro.models.transformer import paged_block_bytes as jax_bytes
    assert paged_block_bytes(port_cfg(cfg), 8) == jax_bytes(cfg, 8)
    pool = init_paged_cache(port_cfg(cfg), 5, 8)
    jpool = build_model(cfg).init_paged_cache(5, 8)
    for k in ("k", "v"):
        assert tuple(pool[k].shape) == jpool[k].shape
        assert pool[k].dtype == torch.float32


@pytest.mark.parametrize("kw,match", [
    (dict(num_experts=4, num_experts_per_tok=2, arch_type="moe"), "dense"),
])
def test_unported_features_raise(kw, match):
    cfg = port_cfg(tiny_cfg("dense", **kw))
    with pytest.raises(NotImplementedError, match=match):
        pool = init_paged_cache(cfg, 4, 8)
        params = init_params(cfg)
        decode_step_paged(params, pool, {
            "token": torch.zeros((1, 1), dtype=torch.int32),
            "position": torch.zeros(1, dtype=torch.int32),
            "block_table": torch.zeros((1, 1), dtype=torch.int32)}, cfg)


def test_unknown_kv_cache_dtype_raises_value_error():
    """As the JAX package's ``kv_quant_dtype`` does."""
    cfg = port_cfg(tiny_cfg("dense", kv_cache_dtype="fp4"))
    with pytest.raises(ValueError, match="unknown kv_cache_dtype 'fp4'"):
        init_paged_cache(cfg, 4, 8)
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        paged_block_bytes(cfg, 8)


# ---------------------------------------------------------------------------
# Paged steps: port vs JAX on the same params and inputs
# ---------------------------------------------------------------------------

def _random_pool(rng, cfg, NB, bs):
    shape = (cfg.num_layers, NB, bs, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


def _compare_step(tiny, T, seed):
    cfg, m, params, tparams = tiny
    rng = np.random.default_rng(seed)
    S, bs, MB = 5, 8, 4
    NB = S * MB + 3
    tables, start, n_tok, live = paged_tables(rng, S, NB, bs, MB, T=T)
    pool = _random_pool(rng, cfg, NB, bs)
    tokens = rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32)
    t = np.arange(T)[None, :]
    pos = np.where((start[:, None] >= 0) & (t < n_tok[:, None]),
                   start[:, None] + t, -1).astype(np.int32)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    if T == 1:
        jb = {"token": jnp.asarray(tokens), "position": jnp.asarray(pos[:, 0]),
              "block_table": jnp.asarray(tables)}
        want, jpool = m.decode_step_paged(params, jpool, jb)
        tb = {"token": torch.from_numpy(tokens),
              "position": torch.from_numpy(pos[:, 0].copy()),
              "block_table": torch.from_numpy(tables)}
        got, tpool2 = decode_step_paged(tparams, tpool, tb, port_cfg(cfg))
    else:
        jb = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
              "block_table": jnp.asarray(tables)}
        want, jpool = m.verify_step_paged(params, jpool, jb)
        tb = {"tokens": torch.from_numpy(tokens),
              "positions": torch.from_numpy(pos),
              "block_table": torch.from_numpy(tables)}
        got, tpool2 = verify_step_paged(tparams, tpool, tb, port_cfg(cfg))
    assert tpool2 is tpool                       # updated in place
    assert got.shape == (S, T, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]),
                                   atol=1e-5, rtol=0)
    return live


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_step_paged_matches_jax(tiny, seed):
    live = _compare_step(tiny, T=1, seed=seed)
    assert live.sum() >= 2


@pytest.mark.parametrize("T,seed", [(4, 0), (4, 1), (6, 2)])
def test_verify_step_paged_matches_jax(tiny, T, seed):
    live = _compare_step(tiny, T=T, seed=seed)
    assert live.sum() >= 2 and (~live).sum() >= 1


def test_token_by_token_decode_matches_jax_full_forward(tiny):
    """Feeding a prompt one token at a time through the port's paged
    decode (second slot inactive, shuffled physical blocks) reproduces the
    JAX package's full-sequence forward logits at every position."""
    cfg, m, params, tparams = tiny
    prompt = [3, 1, 4, 1, 5, 9, 2]
    full, _ = m.forward(params, {"tokens": jnp.asarray([prompt])})
    pool = init_paged_cache(port_cfg(cfg), 8, 4)
    table = torch.full((2, 4), -1, dtype=torch.int32)
    table[0, :2] = torch.tensor([3, 6])
    for t, tok in enumerate(prompt):
        logits, pool = decode_step_paged(tparams, pool, {
            "token": torch.tensor([[tok], [0]], dtype=torch.int32),
            "position": torch.tensor([t, -1], dtype=torch.int32),
            "block_table": table}, port_cfg(cfg))
        np.testing.assert_allclose(logits[0, 0].numpy(),
                                   np.asarray(full[0, t]), atol=1e-4,
                                   rtol=0)


def test_verify_chunk_equals_token_by_token_decode(tiny):
    """Within the port: one multi-token verify step writes the same pool
    and gives the same logits as feeding the tokens one by one."""
    cfg, _, _, tparams = tiny
    pcfg = port_cfg(cfg)
    toks = [7, 2, 9, 4, 4]
    table = torch.tensor([[1, 4]], dtype=torch.int32)
    pool_a = init_paged_cache(pcfg, 6, 4)
    pool_b = init_paged_cache(pcfg, 6, 4)
    chunk, _ = verify_step_paged(tparams, pool_a, {
        "tokens": torch.tensor([toks], dtype=torch.int32),
        "positions": torch.arange(5, dtype=torch.int32)[None],
        "block_table": table}, pcfg)
    for t, tok in enumerate(toks):
        one, _ = decode_step_paged(tparams, pool_b, {
            "token": torch.tensor([[tok]], dtype=torch.int32),
            "position": torch.tensor([t], dtype=torch.int32),
            "block_table": table}, pcfg)
        torch.testing.assert_close(chunk[0, t], one[0, 0], atol=1e-5,
                                   rtol=0)
    # layer-1 K/V differ in the last bits: the projections run at another
    # batch size, so CPU matmuls sum in another order
    for k in ("k", "v"):
        torch.testing.assert_close(pool_a[k], pool_b[k], atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,seed", [(1, 0), (1, 3), (4, 1), (6, 2)])
def test_host_scatter_plan_matches_device_selection(tiny, T, seed):
    """The engine's host-made scatter plan keeps the same K/V rows, bound
    for the same pool rows, as the selection ``paged_inputs`` makes from
    the tensors (live, mapped, inside the table; one slot runs past its
    table), and a step given the plan writes the same pool and logits."""
    cfg, _, _, tparams = tiny
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(seed)
    S, bs, MB = 5, 8, 4
    NB = S * MB + 3
    tables, start, n_tok, _ = paged_tables(rng, S, NB, bs, MB, T=T)
    start[1], n_tok[1] = MB * bs - 1, T       # tail falls off the table
    t = np.arange(T)[None, :]
    pos = np.where((start[:, None] >= 0) & (t < n_tok[:, None]),
                   start[:, None] + t, -1).astype(np.int32)
    plan = scatter_plan(pos, tables, bs)
    got = paged_inputs(torch.from_numpy(pos), torch.from_numpy(tables), pcfg,
                       bs)
    np.testing.assert_array_equal(plan[0], got.rows.numpy())
    np.testing.assert_array_equal(plan[1], got.dest.numpy())
    assert plan.shape[1] < (pos >= 0).sum()   # something was dropped

    pool = _random_pool(rng, cfg, NB, bs)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (S, T)).astype(np.int32))
    step = decode_step_paged if T == 1 else verify_step_paged
    outs = []
    for scatter in (None, torch.from_numpy(plan)):
        tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
        batch = {"block_table": torch.from_numpy(tables)}
        if T == 1:
            batch.update(token=tokens, position=torch.from_numpy(pos[:, 0]))
        else:
            batch.update(tokens=tokens, positions=torch.from_numpy(pos))
        if scatter is not None:
            batch["kv_scatter"] = (scatter[0], scatter[1])
        logits, tpool = step(tparams, tpool, batch, pcfg)
        outs.append((logits, tpool))
    torch.testing.assert_close(outs[0][0], outs[1][0], atol=0, rtol=0)
    for k in ("k", "v"):
        torch.testing.assert_close(outs[0][1][k], outs[1][1][k], atol=0,
                                   rtol=0)
