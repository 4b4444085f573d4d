"""The port's continuous-batching engine against the JAX package's engine:
on the same parameters, greedy decoding of the ``RAGGED`` stream (more
requests than slots, prompts longer than the prefill chunk, max_new not a
multiple of it) gives exactly the JAX engine's tokens, with speculative
decoding off and on and with the prefix cache."""
import jax
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.models.transformer import build_model, init_params
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch import Engine, Request
from torch_parity import RAGGED, port_cfg, port_params

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

TPL = [7, 3, 9, 1, 5, 2, 8, 4] * 3      # 24-token template = 3 blocks @ bs=8
SHARED = [TPL + [50 + i] * (i % 4 + 1) for i in range(6)]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg("dense")
    params, _ = init_params(cfg, jax.random.key(0))
    return cfg, params, port_params(cfg, params)


def _pair(tiny, **kw):
    cfg, params, tparams = tiny
    kw = dict(dict(num_slots=4, max_len=64, block_size=8), **kw)
    return (JaxEngine(build_model(cfg), params, **kw),
            Engine(port_cfg(cfg), tparams, device="cpu", **kw))


@pytest.mark.parametrize("kw", [{}, {"spec_k": 3}, {"prefix_cache": True}],
                         ids=["spec0", "spec3", "prefix"])
def test_greedy_tokens_equal_jax_engine_on_ragged(tiny, kw):
    jax_eng, eng = _pair(tiny, **kw)
    want = jax_eng.generate_ids(RAGGED, max_new=13)
    got = eng.generate_ids(RAGGED, max_new=13)
    np.testing.assert_array_equal(got, want)


def test_warm_prefix_cache_with_speculation_equals_jax_engine(tiny):
    """Shared-template traffic through a warm prefix cache (COW forks,
    attached blocks, skipped prefill) with spec_k=4 on both sides."""
    jax_eng, eng = _pair(tiny, spec_k=4, prefix_cache=True)
    for _ in range(2):                  # cold, then warm
        jr = [JaxRequest(rid=i, prompt=list(p), max_new=9)
              for i, p in enumerate(SHARED)]
        tr = [Request(rid=i, prompt=list(p), max_new=9)
              for i, p in enumerate(SHARED)]
        js, ts = jax_eng.run(jr), eng.run(tr)
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
        for k in ("generated", "prefill_tokens", "prefix_skipped_tokens",
                  "drafted", "accepted", "step_calls"):
            assert ts[k] == js[k], k
        assert ts["prefix"] == js["prefix"]
