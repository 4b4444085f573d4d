#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--out report.json]

Run from the root of a checkout.  Phases, each fatal on failure:

1. build every CUDA source of the port (``src/repro_torch/kernels/csrc``),
   one nvcc per source, all started together;
2. hold each kernel against its plain PyTorch version on the card at
   nanochat-d20 shapes (S=8 slots, KV=10, G=1, D=128, bs=16, MB=32; ragged
   positions, unmapped blocks, inactive slots), plus a G=2 case and a
   sliding-window case, in float32 and bfloat16;
3. one ``decode_step_paged`` and one ``verify_step_paged`` at full width
   (depth 2) on the card against the same step on the CPU, same params;
4. the main path: ``repro_torch.Engine`` with the full nanochat-d20 config
   (seeded random params, 8 ragged token-id requests, max_new 32) with
   spec_k=0 and spec_k=4; greedy tokens must be equal, spec_k=4 must
   have drafted (one prompt repeats an n-gram), and every kernel of each
   run must have launched (counts reset just before each run);
   then one shorter spec_k=0 run under torch.profiler for the device
   time by kernel and the device's busy share;
5. time each kernel, its plain version and one PyTorch library call on
   the same inputs (CUDA events, L2 flushed before each launch) beside
   the least time the card could take (bound).

Prints the card's name and power limit, then a ``{"kernels": [...]}``
line, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
nonzero, with no result, when CUDA is unavailable or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM (NVIDIA data sheet): HBM bandwidth and dense peaks by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}   # (atol, rtol)
REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:41",
    "rmsnorm_residual": "src/repro/kernels/rmsnorm/kernel.py:58",
    "paged_decode": "src/repro/kernels/decode_attention/kernel.py:468",
    "paged_verify": "src/repro/kernels/decode_attention/kernel.py:317",
}
SOURCE = {
    "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "rmsnorm_residual": "src/repro_torch/kernels/csrc/rmsnorm.cu",
    "paged_decode": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "paged_verify": "src/repro_torch/kernels/csrc/paged_attention.cu",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(torch, *, S=8, KV=10, G=1, D=128, bs=16, MB=32, T=1,
               dtype="float32", seed=0):
    """Random q / pools and a ragged block table at the given shape.
    Slot 6 is inactive, slot 2 has an unmapped early block, slot 4 a
    mid-sequence one; blocks are shuffled physical ids.  Returns
    (q, k_pool, v_pool, tables, start, n_tok, live (S, T) bool host)."""
    g = torch.Generator().manual_seed(seed)
    dt = getattr(torch, dtype)
    NB = S * MB
    cap = MB * bs
    starts = [0, 17, 100, 255, 300, cap - 40, -1, 64][:S]
    starts += [int(x) for x in torch.randint(0, cap - T, (S - len(starts),),
                                             generator=g)]
    n_tok = [T if s >= 0 else 0 for s in starts]
    if T > 1:
        n_tok = [min(T, 1 + (i % T)) if s >= 0 else 0
                 for i, s in enumerate(starts)]
    perm = torch.randperm(NB, generator=g)
    tables = torch.full((S, MB), -1, dtype=torch.int32)
    for s in range(S):
        if starts[s] < 0:
            continue
        nblk = (starts[s] + n_tok[s] - 1) // bs + 1
        tables[s, :nblk] = perm[s * MB:s * MB + nblk].to(torch.int32)
    tables[2, 0] = -1
    tables[4, 5] = -1
    q_shape = (S, KV, G, D) if T == 1 else (S, T, KV, G, D)
    q = torch.randn(q_shape, generator=g).to(dt)
    k_pool = torch.randn((NB, bs, KV, D), generator=g).to(dt)
    v_pool = torch.randn((NB, bs, KV, D), generator=g).to(dt)
    live = torch.zeros((S, T), dtype=torch.bool)
    for s in range(S):
        for t in range(n_tok[s]):
            pos = starts[s] + t
            live[s, t] = tables[s, pos // bs] >= 0      # own key attendable
    return (q, k_pool, v_pool, tables,
            torch.tensor(starts, dtype=torch.int32),
            torch.tensor(n_tok, dtype=torch.int32), live)


def max_err(torch, got, want, live=None):
    """Max abs error (over live rows) and whether it is within the dtype's
    tolerance."""
    atol, rtol = TOL[str(got.dtype).replace("torch.", "")]
    got, want = got.float(), want.float()
    if live is not None:
        got, want = got[live], want[live]
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return float(err.max()) if err.numel() else 0.0, ok


def phase_kernels(torch, results):
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_verify_attention, paged_verify_attention_plain)
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                             rmsnorm_residual,
                                             rmsnorm_residual_plain)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for rows in (8, 40):
            x = (torch.randn((rows, 1280), generator=g) * 2).to(dt).to(dev)
            r = torch.randn((rows, 1280), generator=g).to(dt).to(dev)
            sc = (1 + 0.1 * torch.randn(1280, generator=g)).to(dev)
            err, ok = max_err(torch, rmsnorm(x, sc), rmsnorm_plain(x, sc))
            results.append(("rmsnorm", dtype, (rows, 1280), err, ok))
            (o, h), (o2, h2) = (rmsnorm_residual(x, r, sc),
                                rmsnorm_residual_plain(x, r, sc))
            e1, ok1 = max_err(torch, o, o2)
            e2, ok2 = max_err(torch, h, h2)
            results.append(("rmsnorm_residual", dtype, (rows, 1280),
                            max(e1, e2), ok1 and ok2))
        cases = [dict(), dict(KV=5, G=2), dict(window=64)]
        for case in cases:
            case = dict(case)
            window = case.pop("window", 0)
            for T in (1, 5):
                q, kp, vp, tab, start, ntok, live = paged_case(
                    torch, T=T, dtype=dtype, seed=T + 10 * len(case), **case)
                q, kp, vp, tab, start, ntok = (t.to(dev) for t in
                                               (q, kp, vp, tab, start, ntok))
                if T == 1:
                    got = paged_decode_attention(q, kp, vp, tab, start,
                                                 window=window)
                    want = paged_decode_attention_plain(q, kp, vp, tab,
                                                        start, window)
                    mask = live[:, 0].to(dev)
                    name = "paged_decode"
                else:
                    got = paged_verify_attention(q, kp, vp, tab, start, ntok,
                                                 window=window)
                    want = paged_verify_attention_plain(q, kp, vp, tab, start,
                                                        ntok, window)
                    mask = live.to(dev)
                    name = "paged_verify"
                torch.cuda.synchronize()
                err, ok = max_err(torch, got, want, mask)
                results.append((name, dtype, tuple(q.shape) + (
                    f"window={window}",), err, ok))
    for name, dtype, shape, err, ok in results:
        log(f"  {name:17s} {dtype:9s} {str(shape):40s} max_abs_err={err:.3e}"
            f" {'ok' if ok else 'FAIL'}")
    check(all(r[-1] for r in results), "a kernel disagrees with its plain "
          "version")


# ---------------------------------------------------------------------------
# Phase 3: full-width step on the card vs the CPU
# ---------------------------------------------------------------------------

def phase_step_vs_cpu(torch):
    from repro_torch.configs import NANOCHAT_D20
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    init_params, verify_step_paged)
    from repro_torch.models.transformer import flatten, unflatten
    cfg = NANOCHAT_D20.with_(num_layers=2)
    params = init_params(cfg, seed=0, device="cpu")
    params_d = unflatten({k: v.cuda() for k, v in flatten(params).items()})
    g = torch.Generator().manual_seed(3)
    S, bs, MB, T = 8, 16, 32, 5
    _, _, _, tab, start, ntok, live = paged_case(torch, T=T, S=S, seed=5)
    worst = {}
    for kind in ("decode", "verify"):
        pool = init_paged_cache(cfg, S * MB, bs)
        for buf in pool.values():
            buf.normal_(generator=g)
        pool_d = {k: v.cuda() for k, v in pool.items()}
        if kind == "decode":
            batch = {"token": torch.randint(0, cfg.vocab_size, (S, 1),
                                            generator=g, dtype=torch.int32),
                     "position": start.clone(), "block_table": tab}
            step, rows = decode_step_paged, live[:, :1]
        else:
            t = torch.arange(T)[None, :]
            ok = (start[:, None] >= 0) & (t < ntok[:, None])
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (S, T),
                                             generator=g, dtype=torch.int32),
                     "positions": torch.where(ok, start[:, None] + t,
                                              -1).to(torch.int32),
                     "block_table": tab}
            step, rows = verify_step_paged, live
        batch_d = {k: v.cuda() for k, v in batch.items()}
        want, pool = step(params, pool, batch, cfg)
        got, pool_d = step(params_d, pool_d, batch_d, cfg)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{kind}: non-finite logits")
        e_logit = float((got.cpu() - want)[rows].abs().max())
        e_pool = max(float((pool_d[k].cpu() - pool[k]).abs().max())
                     for k in ("k", "v"))
        worst[kind] = (e_logit, e_pool)
        log(f"  {kind}_step_paged d20 width, depth 2: logits max_abs_err="
            f"{e_logit:.3e} (atol 2e-3), pool max_abs_err={e_pool:.3e} "
            f"(atol 1e-4)")
        check(e_logit <= 2e-3 and e_pool <= 1e-4,
              f"{kind} step on the card disagrees with the CPU")
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

PROMPT_LENS = (5, 16, 64, 128, 33, 200, 9, 300)


def phase_engine(torch):
    from repro_torch import Engine, Request
    from repro_torch.configs import NANOCHAT_D20
    from repro_torch.kernels import KERNELS, launches, reset_launches
    from repro_torch.models import init_params
    cfg = NANOCHAT_D20
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  nanochat-d20 params: {cfg.param_count() / 1e6:.1f} M on the card "
        f"({time.perf_counter() - t0:.1f} s to init)")
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in PROMPT_LENS]
    # 16 = 3 chunks of spec_k+1 = 5 and one token left, fed as a decode
    # round whose carry ends an n-gram seen earlier in the prompt: the
    # drafter proposes prompt[6:10], so spec_k=4 verifies real drafts and
    # rolls back the rejected ones
    prompts[1][13:16] = prompts[1][3:6]
    need = {0: ("rmsnorm", "rmsnorm_residual", "paged_decode"),
            4: ("rmsnorm", "rmsnorm_residual", "paged_verify")}
    out, runs = {}, {}
    for spec_k in (0, 4):
        eng = Engine(cfg, params, max_len=512, num_slots=8, block_size=16,
                     spec_k=spec_k, device="cuda")
        eng.run([Request(rid=99, prompt=[1, 2, 3], max_new=2)])   # warm-up
        reqs = [Request(rid=i, prompt=p, max_new=32)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        reset_launches()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        counts = {k: launches[k] for k in KERNELS}
        out[spec_k] = [r.tokens for r in reqs]
        tps = stats["generated"] / stats["wall"]
        runs[spec_k] = {"launches": counts, "wall_s": stats["wall"],
                        "generated": stats["generated"],
                        "step_calls": stats["step_calls"],
                        "tokens_per_s": tps,
                        "drafted": stats.get("drafted", 0),
                        "accepted": stats.get("accepted", 0)}
        log(f"  Engine spec_k={spec_k}: {stats['generated']} tokens in "
            f"{stats['wall']:.3f} s ({tps:.1f} tokens/s), "
            f"{stats['step_calls']} step calls, drafted "
            f"{stats.get('drafted', 0)} accepted {stats.get('accepted', 0)}, "
            f"launches {counts}")
        for r in reqs:
            check(len(r.tokens) == 32 and all(0 <= t < cfg.vocab_size
                                              for t in r.tokens),
                  f"spec_k={spec_k}: request {r.rid} output malformed")
        for k in need[spec_k]:
            check(counts[k] > 0, f"spec_k={spec_k}: kernel {k} never "
                  f"launched on the main path")
        if spec_k:
            check(stats["drafted"] > 0, "spec_k=4 drafted no token")
        del eng
        torch.cuda.empty_cache()
    check(out[0] == out[4], "greedy tokens differ between spec_k=0 and 4")
    log("  greedy tokens equal between spec_k=0 and spec_k=4")
    eng = Engine(cfg, params, max_len=512, num_slots=8, block_size=16,
                 device="cuda")
    profile = profile_engine(torch, eng, prompts)
    return runs, profile


def profile_engine(torch, eng, prompts, max_new=8):
    """Device time by kernel over one spec_k=0 run of the same prompts
    (torch.profiler, device activity only), and the device's busy share
    of the run's wall time.  Tracing slows the host a little, so the busy
    share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import Request
    reqs = [Request(rid=100 + i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us
    busy_s = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"wall_s": wall, "device_busy_s": busy_s,
           "busy_share": busy_s / wall if wall else None,
           "token_steps": stats["step_calls"] * eng.prefill_chunk,
           "top_kernels_ms": [(k, us / 1e3) for k, us in top]}
    if not by_name:
        log("  profiler: no device time recorded (not measured)")
        return out
    log(f"  profiled spec_k=0 run (max_new={max_new}): wall {wall:.3f} s, "
        f"device busy {busy_s:.3f} s ({100 * busy_s / wall:.1f}%), "
        f"{out['token_steps']} token-steps")
    for k, ms in out["top_kernels_ms"]:
        log(f"    {ms:9.2f} ms  {100 * ms / 1e3 / busy_s:5.1f}%  {k[:90]}")
    return out


# ---------------------------------------------------------------------------
# Phase 5: timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps=50):
    """Mean device ms of fn() with the L2 cache flushed before each call
    (the main path finds these operands cold: other layers' weights and
    KV pass through L2 between two calls of one layer).  A sleep kernel
    ahead of each timed call keeps the card busy while the host enqueues
    it, so the host's launch overhead stays outside the events."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(2_000_000)          # ~1 ms at 1.98 GHz
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_timing(torch, runs, checks):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_plain,
        paged_verify_attention, paged_verify_attention_plain)
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_plain,
                                             rmsnorm_residual,
                                             rmsnorm_residual_plain)
    dev = torch.device("cuda")
    dtype = "float32"                     # the main path's working type
    item = 4
    rows, d = 8, 1280                     # a decode step's S*T rows
    x = torch.randn((rows, 1, d), device=dev)
    r = torch.randn((rows, 1, d), device=dev)
    sc = torch.ones(d, device=dev)
    out = []

    def row(name, shape, ms, plain_ms, lib_ms, nbytes, ops):
        b_ms, b_by = bound(nbytes, ops, dtype)
        err = {dt: max(e for n, t, _, e, _ in checks if n == name and t == dt)
               for dt in ("float32", "bfloat16")}
        out.append({"name": name, "route": "cuda", "source": SOURCE[name],
                    "replaces": REPLACES[name],
                    "launches": sum(run["launches"][name]
                                    for run in runs.values()),
                    "launches_by_path": {f"spec_k{k}": run["launches"][name]
                                         for k, run in runs.items()},
                    "max_abs_err": err[dtype], "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "dtype": dtype, "shape": list(shape),
                    "max_abs_err_bf16": err["bfloat16"]})

    row("rmsnorm", x.shape,
        time_ms(torch, lambda: rmsnorm(x, sc)),
        time_ms(torch, lambda: rmsnorm_plain(x, sc)),
        time_ms(torch, lambda: F.rms_norm(x, (d,), sc, 1e-5)),
        (2 * rows * d) * item + d * 4, 4 * rows * d)
    row("rmsnorm_residual", x.shape,
        time_ms(torch, lambda: rmsnorm_residual(x, r, sc)),
        time_ms(torch, lambda: rmsnorm_residual_plain(x, r, sc)),
        None, (4 * rows * d) * item + d * 4, 5 * rows * d)

    for name, T in (("paged_decode", 1), ("paged_verify", 5)):
        q, kp, vp, tab, start, ntok, live = (
            t.to(dev) for t in paged_case(torch, T=T, dtype=dtype, seed=T))
        S, KV, G, D = q.shape[0], q.shape[-3], q.shape[-2], q.shape[-1]
        bs, MB = kp.shape[1], tab.shape[1]
        # what this run's data needs (window 0): q in and out for each
        # query that attends some key, each K/V row at a mapped position
        # <= the slot's last query once, the table entries up to that
        # query's block, and the per-slot positions (and counts)
        kv_rows, pairs, q_rows, tab_reads = 0, 0, 0, 0
        tab_h, start_h, ntok_h = tab.cpu(), start.cpu(), ntok.cpu()
        for s in range(S):
            st, n = int(start_h[s]), int(ntok_h[s])
            if st < 0 or n == 0:
                continue
            last = st + n - 1
            mapped = [int(tab_h[s, p // bs]) >= 0 for p in range(last + 1)]
            kv_rows += sum(mapped)
            tab_reads += last // bs + 1
            for t in range(n):
                keys = sum(mapped[:st + t + 1])
                pairs += keys
                q_rows += keys > 0
        nbytes = ((2 * kv_rows * KV * D + 2 * q_rows * KV * G * D) * item
                  + (tab_reads + S * (1 if T == 1 else 2)) * 4)
        ops = 4 * pairs * KV * G * D
        # library yardstick: SDPA over the gathered KV with a boolean mask
        L = MB * bs
        safe = tab.clamp(min=0).long()
        kg = kp[safe].reshape(S, L, KV, D).transpose(1, 2)
        vg = vp[safe].reshape(S, L, KV, D).transpose(1, 2)
        kg = kg.repeat_interleave(G, dim=1).contiguous()
        vg = vg.repeat_interleave(G, dim=1).contiguous()
        tq = torch.arange(T, device=dev)
        qpos = start.long()[:, None] + tq[None, :]
        mapped = (tab >= 0).repeat_interleave(bs, dim=1)
        mask = ((torch.arange(L, device=dev)[None, None, :]
                 <= qpos[:, :, None]) & mapped[:, None, :])[:, None]
        mask = mask | ~mask.any(-1, keepdim=True)      # no empty rows
        if T == 1:
            qs = q.reshape(S, KV * G, 1, D)
            fn = lambda: paged_decode_attention(q, kp, vp, tab, start)
            plain = lambda: paged_decode_attention_plain(q, kp, vp, tab,
                                                         start)
        else:
            qs = q.permute(0, 2, 3, 1, 4).reshape(S, KV * G, T, D)
            fn = lambda: paged_verify_attention(q, kp, vp, tab, start, ntok)
            plain = lambda: paged_verify_attention_plain(q, kp, vp, tab,
                                                         start, ntok)
        lib = lambda: F.scaled_dot_product_attention(qs, kg, vg,
                                                     attn_mask=mask)
        row(name, q.shape, time_ms(torch, fn), time_ms(torch, plain),
            time_ms(torch, lib), nbytes, ops)
    return out


# ---------------------------------------------------------------------------

def gpu_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=str, default=None,
                    help="also write the full report as JSON to this file")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"gpu": gpu_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    try:
        from repro_torch.kernels import _build
        log("[1/5] build kernels")
        t0 = time.perf_counter()
        text = _build.build(verbose=True)
        report["build_s"] = time.perf_counter() - t0
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "error" in line.lower():
                log("  " + line.strip())
        log(f"  built in {report['build_s']:.1f} s")

        log("[2/5] kernels vs plain versions")
        checks = []
        phase_kernels(torch, checks)
        report["checks"] = [list(c) for c in checks]

        log("[3/5] full-width step: card vs CPU")
        report["step_vs_cpu"] = phase_step_vs_cpu(torch)

        log("[4/5] Engine, nanochat-d20, spec_k=0 and 4")
        runs, report["profile"] = phase_engine(torch)
        report["engine"] = runs

        log("[5/5] kernel timing")
        kernels = phase_timing(torch, runs, checks)
        report["kernels"] = kernels
        for k in kernels:
            log(f"  {k['name']:17s} ms={k['ms']:.4f} plain_ms="
                f"{k['plain_ms']:.4f} library_ms={k['library_ms']} "
                f"bound_ms={k['bound_ms']:.5f} ({k['bound_by']}) "
                f"launches={k['launches_by_path']}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    summary = {k: {"tokens_per_s": v["tokens_per_s"], "wall_s": v["wall_s"]}
               for k, v in runs.items()}
    print(json.dumps({"engine_spec_k": summary}))
    print(report["gpu"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
