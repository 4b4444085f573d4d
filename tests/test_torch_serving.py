"""The port's serving stack on its own terms: the bit-exactness properties
the JAX package pins for itself, pinned inside the port (spec == non-spec
greedy, sharing on == off, sampled tokens independent of the schedule),
the host-side modules held to the JAX package's copies, the entry points'
CUDA-by-default rule, the serve CLI, and the package's import rules."""
import ast
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.configs import base as jax_configs
from repro.data.pipeline import PackedDataset as JaxPackedDataset
from repro.data.pipeline import build_tokenizer as jax_build_tokenizer
from repro.data.synthetic import World as JaxWorld
from repro.data.synthetic import gen_pretrain_texts as jax_texts
from repro.data.tokenizer import BPETokenizer as JaxBPE
from repro.serving import KVBlockPool as JaxPool
from repro.serving import PrefixTree as JaxTree
from repro.serving import Request as JaxRequest
from repro.serving import Scheduler as JaxScheduler
from repro.serving.drafter import propose as jax_propose
from repro_torch import Engine, Request
from repro_torch.configs import base as port_configs
from repro_torch.data import PackedDataset, build_tokenizer
from repro_torch.data.pipeline import build_tokenizer as port_build_tokenizer
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.serving import (KVBlockPool, PrefixTree, Scheduler,
                                 draft_propose)
from torch_parity import RAGGED, port_cfg

# tiny shapes: intra-op threads would only contend with the other test
# workers on the same cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TPL = [7, 3, 9, 1, 5, 2, 8, 4] * 3      # 24-token template = 3 blocks @ bs=8
SHARED = [TPL + [50 + i] * (i % 4 + 1) for i in range(6)]


@pytest.fixture(scope="module")
def params():
    return init_params(port_cfg(tiny_cfg("dense")), seed=0)


def _engine(params, **kw):
    kw = dict(dict(num_slots=4, max_len=64, block_size=8), **kw)
    return Engine(port_cfg(tiny_cfg("dense")), params, device="cpu", **kw)


def _run(eng, prompts, max_new=9, seed=0, **rkw):
    reqs = [Request(rid=i, prompt=list(p), max_new=max_new, **rkw)
            for i, p in enumerate(prompts)]
    stats = eng.run(reqs, seed=seed)
    return [r.tokens for r in reqs], stats


# ---------------------------------------------------------------------------
# Bit-exactness inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [1, 4])
def test_speculative_greedy_equals_sequential(params, spec_k):
    want = _engine(params).generate_ids(RAGGED, max_new=13)
    eng = _engine(params, spec_k=spec_k)
    got = eng.generate_ids(RAGGED, max_new=13)
    np.testing.assert_array_equal(got, want)


def test_prefix_sharing_greedy_bit_exact(params):
    want, _ = _run(_engine(params), SHARED)
    on = _engine(params, prefix_cache=True)
    cold, s1 = _run(on, SHARED)
    warm, s2 = _run(on, SHARED)
    assert want == cold == warm
    assert s2["prefix"]["hit_rate"] == 1.0
    assert s2["prefix"]["forked"] > 0
    assert s2["prefix_skipped_tokens"] > 0
    assert s2["prefill_tokens"] < s1["prefill_tokens"]


def test_policies_give_identical_outputs(params):
    outs = [_engine(params, policy=p, num_slots=2).generate_ids(
        RAGGED[:6], max_new=6) for p in ("fifo", "longest_prefill",
                                         "cache_aware")]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("spec_k", [0, 3])
def test_sampled_tokens_identical_across_num_slots(params, spec_k):
    """Draws are keyed by (seed, rid, position): how many slots shared the
    step cannot change a request's sampled tokens."""
    outs = []
    for slots in (1, 2, 4):
        toks, _ = _run(_engine(params, num_slots=slots, spec_k=spec_k),
                       RAGGED[:5], max_new=7, seed=5, greedy=False,
                       temperature=1.3)
        outs.append(toks)
    assert outs[0] == outs[1] == outs[2]
    again, _ = _run(_engine(params, spec_k=spec_k), RAGGED[:5], max_new=7,
                    seed=6, greedy=False, temperature=1.3)
    assert again != outs[0]                   # the seed matters


def test_sampled_request_independent_of_its_batch(params):
    eng = _engine(params)
    alone = Request(rid=7, prompt=[5, 6], max_new=6, greedy=False,
                    temperature=1.3)
    eng.run([alone], seed=11)
    crowd = [Request(rid=i, prompt=[i + 1] * (i + 1), max_new=4,
                     greedy=False) for i in range(5)]
    together = Request(rid=7, prompt=[5, 6], max_new=6, greedy=False,
                       temperature=1.3)
    eng.run(crowd + [together], seed=11)
    assert together.tokens == alone.tokens


def test_sampled_request_unaffected_by_prefix_sharing(params):
    alone = Request(rid=3, prompt=TPL + [50, 51], max_new=6, greedy=False,
                    temperature=1.3)
    _engine(params).run([alone], seed=11)
    on = _engine(params, prefix_cache=True)
    on.run([Request(rid=9, prompt=TPL + [60], max_new=4)])  # prime cache
    shared = Request(rid=3, prompt=TPL + [50, 51], max_new=6, greedy=False,
                     temperature=1.3)
    on.run([shared], seed=11)
    assert shared.tokens == alone.tokens


def test_temperature_reaches_the_sampler(params):
    eng = _engine(params)
    greedy = eng.generate_ids([[3, 1, 4, 1, 5]], max_new=8)
    cold = eng.generate_ids([[3, 1, 4, 1, 5]], max_new=8, greedy=False,
                            temperature=1e-4)
    np.testing.assert_array_equal(cold, greedy)
    hot = eng.generate_ids([[3, 1, 4, 1, 5]], max_new=8, greedy=False,
                           temperature=8.0)
    assert (hot != cold).any()


def test_eos_evicts_early_and_prefix_matches(params):
    eng = _engine(params)
    full = eng.generate_ids([[3, 1, 4, 1, 5]], max_new=8)[0]
    eos = int(full[3])
    r = Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new=8, eos_id=eos)
    eng.run([r])
    assert r.tokens[-1] == eos and len(r.tokens) <= 8
    np.testing.assert_array_equal(r.tokens, full[:len(r.tokens)])


def test_churn_small_pool_completes_and_matches_solo(params):
    rng = np.random.default_rng(0)
    eng = _engine(params, num_slots=2, max_len=24)
    prompts = [rng.integers(1, 90, size=int(rng.integers(1, 12))).tolist()
               for _ in range(9)]
    reqs = [Request(rid=i, prompt=p, max_new=int(rng.integers(1, 8)))
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    solo = _engine(params, num_slots=2, max_len=24)
    for r in reqs:
        assert len(r.tokens) == r.max_new
        np.testing.assert_array_equal(
            r.tokens, solo.generate_ids([r.prompt], max_new=r.max_new)[0])


def test_deadline_expires_requests_under_wall_clock(params):
    eng = _engine(params, num_slots=1)
    slow = Request(rid=0, prompt=[1] * 30, max_new=30, deadline_s=0.0)
    ok = Request(rid=1, prompt=[2, 3], max_new=3)
    stats = eng.run([slow, ok], use_time=True)
    assert stats["expired"] >= 1 and slow.expired
    assert len(ok.tokens) == 3 and not ok.expired


def test_kv_report_and_pool_bytes(params):
    eng = _engine(params, pool_bytes=65536)
    rep = eng.kv_report()
    assert rep["kv_pool_dtype"] == "float32"
    assert rep["pool_bytes"] <= 65536 and rep["num_blocks"] == eng.num_blocks
    assert eng.bytes_per_block == 2 * 2 * 8 * 2 * 16 * 4


# ---------------------------------------------------------------------------
# Entry points: CUDA by default, no silent fallback, no silent degrade
# ---------------------------------------------------------------------------

def test_engine_defaults_to_cuda_and_never_falls_back(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(port_cfg(tiny_cfg("dense")), params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--prompt", "hi"])


def test_engine_refuses_params_on_another_device(params):
    meta = {k: {kk: (v.to("meta") if not isinstance(v, dict) else v)
                for kk, v in sub.items()} for k, sub in params.items()}
    with pytest.raises(ValueError, match="is on meta"):
        _engine(meta)


@pytest.mark.parametrize("kw,match", [
    (dict(window=8), "sliding-window"),
])
def test_unported_engine_paths_raise(kw, match):
    cfg = port_cfg(tiny_cfg("dense", **kw))
    with pytest.raises(NotImplementedError, match=match):
        Engine(cfg, init_params(cfg), device="cpu")


def test_static_path_batches_raise(params):
    """A batch the scheduler path cannot serve (an empty prompt, max_new <
    1, over capacity) raises nothing now: ``generate`` routes it to the
    static-bucket path, as the JAX package's engine does."""
    eng = _engine(params)
    for prompts, max_new in (([[], [1, 2]], 4), ([[1, 2]], 0),
                             ([[1] * 60], 8)):
        assert not eng._fits(prompts, max_new)
        got = eng.generate(prompts, max_new=max_new)
        want = eng.generate_ids_static(prompts, max_new=max_new)
        assert got == want.tolist() and want.shape == (len(prompts),
                                                       max_new)


# ---------------------------------------------------------------------------
# Host-side modules: the port's copies behave as the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_drafter_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        hist = rng.integers(0, 4 + seed, size=int(rng.integers(1, 40)))
        hist = [int(t) for t in hist]
        k = int(rng.integers(0, 6))
        assert draft_propose(hist, k) == jax_propose(hist, k)


@pytest.mark.parametrize("policy", ["fifo", "longest_prefill",
                                    "cache_aware"])
def test_scheduler_and_pool_trace_match_reference(policy):
    """The same admission / mapping / rollback / finish sequence through
    both copies leaves the same slots, tables and ledgers."""
    rng = np.random.default_rng(len(policy))
    sides = []
    for pool_cls, tree_cls, sched_cls, req_cls in (
            (KVBlockPool, PrefixTree, Scheduler, Request),
            (JaxPool, JaxTree, JaxScheduler, JaxRequest)):
        pool = pool_cls(24, 4)
        sides.append((pool, sched_cls(3, pool, 8, policy,
                                      tree=tree_cls(4)), req_cls))
    prompts = [list(TPL[:int(n)]) + [int(t)] for n, t in
               zip(rng.integers(2, 20, 12), rng.integers(60, 70, 12))]
    trace = [[] for _ in sides]
    for rid, prompt in enumerate(prompts):
        for (pool, sched, req_cls), out in zip(sides, trace):
            sched.submit(req_cls(rid=rid, prompt=prompt, max_new=3))
            newly = sched.admit()
            for si in newly:
                slot = sched.slots[si]
                if slot.cow is not None:
                    sched.cow_executed(si)
                sched.ensure_mapped(si, len(slot.req.prompt) + 1)
                sched.register_prefix(si)
                pool.truncate(slot, len(slot.req.prompt))
            if rid % 2:
                for si in sched.active_slots()[:1]:
                    sched.finish(si)
            pool.check_invariants()
            out.append((newly, [(s.pos, list(s.blocks), s.reserved)
                                if s else None for s in sched.slots],
                        pool.num_free, pool.num_reserved, pool.num_shared,
                        sched.prefix_report()))
    assert trace[0] == trace[1]


def test_tokenizer_matches_reference_pipeline():
    world = JaxWorld.make(40, seed=1234)
    ref = JaxBPE.train(jax_texts(world, 2000, seed=0), 512)
    tok = build_tokenizer()
    assert tok.merges == ref.merges and tok.vocab_size == ref.vocab_size
    s = "<|bos|><|user_start|>what is the color of ent3 ?<|user_end|>"
    ids = tok.encode(s)
    assert ids == ref.encode(s) and tok.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("name", ["ModelConfig", "DiLoCoConfig",
                                  "OptimizerConfig"])
def test_config_copies_match_the_reference_field_for_field(name):
    import dataclasses
    ours, ref = getattr(port_configs, name), getattr(jax_configs, name)
    fields = lambda c: [(f.name, f.default if f.default is not
                         dataclasses.MISSING else f.default_factory())
                        for f in dataclasses.fields(c)]
    assert fields(ours) == fields(ref)


def test_mamba2_config_copy_matches_the_reference_field_for_field():
    import dataclasses
    from repro.configs.mamba2_13b import CONFIG as JAX_MAMBA2
    from repro_torch.configs import MAMBA2_13B
    assert dataclasses.asdict(MAMBA2_13B) == dataclasses.asdict(JAX_MAMBA2)


def test_params_from_numpy_round_trips_a_tiny_ssm_tree():
    """The SSM leaves (layers/mamba/*, ln1, no attn / ln2 / mlp) go through
    the checkpoint mapping both ways, and a missing leaf is refused."""
    from repro_torch.checkpoint import params_from_numpy, params_to_numpy
    cfg = port_cfg(tiny_cfg("ssm"))
    flat = params_to_numpy(init_params(cfg, seed=3))
    assert {k for k in flat if k.startswith("layers/")} == {
        "layers/ln1/scale"} | {f"layers/mamba/{k}" for k in (
            "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
            "norm_scale", "out_proj")}
    again = params_to_numpy(params_from_numpy(flat, cfg))
    assert again.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k])
    flat.pop("layers/mamba/D")
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy(flat, cfg)


def test_packed_dataset_and_tokenizer_copies_match_the_reference():
    """The port's copy of the numpy-only pipeline: the same tokenizer, the
    same packed stream, the same merged and per-worker batches."""
    world = JaxWorld.make(40, seed=1234)
    texts = jax_texts(world, 300, seed=0)
    ref_tok = jax_build_tokenizer(texts, 300)
    tok = port_build_tokenizer(texts, 300)
    assert tok.merges == ref_tok.merges
    ref = JaxPackedDataset.from_texts(texts, ref_tok, 32)
    ds = PackedDataset.from_texts(texts, tok, 32)
    np.testing.assert_array_equal(ds.tokens, ref.tokens)
    assert ds.num_tokens == ref.num_tokens
    for step in (0, 5):
        for a, b in ((ds.batch(step, 3, seed=1), ref.batch(step, 3, seed=1)),
                     (ds.worker_batches(step, 2, 3, seed=1),
                      ref.worker_batches(step, 2, 3, seed=1))):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    tiny = PackedDataset.from_texts(texts[:1], tok, 64)      # tiled up
    ref_tiny = JaxPackedDataset.from_texts(texts[:1], ref_tok, 64)
    np.testing.assert_array_equal(tiny.tokens, ref_tiny.tokens)


# ---------------------------------------------------------------------------
# The serve CLI (plain path on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--spec-k", "3", "--prefix-cache"]])
def test_serve_cli_reports_on_cpu(extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--prompt", "what is the color of "
                    "ent3 ?", "--prompt", "compute 3 + 4 .", "--max-new",
                    "6", "--max-len", "64", "--report"] + extra)
    out = buf.getvalue()
    assert out.count(">>> ") == 2
    assert "# requests=2 generated=" in out and "tokens_per_s=" in out
    assert "# device=cpu kernels=plain" in out
    if extra:
        assert "# spec_k=3 drafted=" in out and "# prefix_cache" in out


def test_serve_cli_loads_a_jax_checkpoint(tmp_path):
    """--ckpt reads the JAX package's checkpoint and config metadata."""
    import jax
    from repro.checkpoint import save_config, save_pytree
    from repro.models.transformer import init_params as jax_init
    cfg = tiny_cfg("dense", vocab_size=512)
    jparams, _ = jax_init(cfg, jax.random.key(0))
    path = str(tmp_path / "ckpt")
    save_pytree(jparams, path)
    save_config(cfg, path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--ckpt", path, "--prompt", "hi",
                    "--max-new", "3", "--max-len", "64"])
    assert "model config from checkpoint metadata" in buf.getvalue()


def test_serve_cli_takes_the_static_fallback_for_an_ssm_checkpoint(
        tmp_path):
    """An SSM checkpoint (config from its .cfg.json) has no paged cache:
    the CLI serves it on the static path and says the report is
    unavailable, as the JAX launcher does."""
    import jax
    from repro.checkpoint import save_config, save_pytree
    from repro.models.transformer import init_params as jax_init
    cfg = tiny_cfg("ssm", vocab_size=512)
    jparams, _ = jax_init(cfg, jax.random.key(0))
    path = str(tmp_path / "ssm")
    save_pytree(jparams, path)
    save_config(cfg, path)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        serve.main(["--device", "cpu", "--ckpt", path, "--prompt", "hi",
                    "--prompt", "compute 3 + 4 .", "--max-new", "3",
                    "--report"])
    assert "model config from checkpoint metadata" in out.getvalue()
    assert out.getvalue().count(">>> ") == 2
    assert "# report unavailable on the static fallback path" in \
        err.getvalue()
    assert "tokens_per_s=" not in out.getvalue()


def test_serve_make_config_names_the_ported_configs():
    assert serve.make_config("mamba2-1.3b", 512).arch_type == "ssm"
    with pytest.raises(NotImplementedError, match="mamba2-1.3b"):
        serve.make_config("hymba", 512)


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------

def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list((REPO / "src" / "repro_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(REPO / path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_wire_constants_copy_the_reference():
    """The port's copies of the wire tables and quantize constants equal
    the JAX package's originals."""
    from repro.core import transport as jax_transport
    from repro.kernels.quantize import kernel as jax_qkernel
    from repro.kernels.quantize import ref as jax_qref
    from repro_torch.core import transport
    from repro_torch.kernels.quantize import QDTYPES, QMAX, SCALE_EPS
    assert transport.WIRE_WIDTH == jax_transport.WIRE_WIDTH
    assert transport._ALIASES == jax_transport._ALIASES
    assert QMAX == jax_qkernel.QMAX and QDTYPES == jax_qkernel.QDTYPES
    assert SCALE_EPS == jax_qref.SCALE_EPS == jax_qkernel.SCALE_EPS


def _code_without_docstrings(path: Path) -> str:
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_faults_module_is_a_copy_of_the_reference():
    """``core/faults.py`` is the JAX package's stdlib-only module, code
    for code (only its docstrings speak the port's terms)."""
    assert (_code_without_docstrings(
        REPO / "src" / "repro_torch" / "core" / "faults.py")
        == _code_without_docstrings(REPO / "src" / "repro" / "core"
                                    / "faults.py"))


@pytest.mark.parametrize("path", ["src/repro_torch/core/transport.py",
                                  "src/repro_torch/core/streaming.py",
                                  "src/repro_torch/core/faults.py"])
def test_wire_modules_import_nothing_of_the_reference(path):
    mods = list(_imports(REPO / path))
    assert mods and all(m.split(".")[0] not in ("jax", "jaxlib", "repro")
                        for m in mods), (path, mods)
