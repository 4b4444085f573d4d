#!/usr/bin/env python3
"""Tile sweep of the flash attention kernels, and the card's mma.sync rate.

    python3 tools/flash_sweep.py [--out flash_sweep.json]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.

1. Each variant of ``VARIANTS`` is a copy of ``src/repro_torch`` under
   ``build/flash_sweep/<name>/`` whose ``csrc/flash_attention.cu`` has
   one tile constant moved from the committed value (the streamed tile of
   the forward, of dQ and of dK/dV, the unroll of the D loop); "chosen"
   is the source as committed.  Every copy builds its own library, all
   at once, with ptxas's report of registers, stack and spills.
2. A child process per variant imports its copy, holds flash_fwd, the fp8
   forward and flash_bwd against their plain versions (f32 and bf16, the
   training shape plus a G = 2, a windowed and a D 16 case, the
   tolerances of ``chip_smoke.py``), then times them (CUDA events, L2
   flushed, ``chip_smoke.time_ms``) at the training shape (B 4, S 1024,
   H = KV = 10, D 128) and the pipeline's (B 8, S 128), f32, with the
   backward's three kernels apart (torch.profiler).
3. Times a loop of independent ``mma.sync`` products per warp on every
   SM: m16n8k8 TF32 (the flash kernels' instruction) and m16n8k16 bf16,
   as TFLOP/s: the ceiling of a kernel built from them.

Prints one line per variant and per rate, then the card's name and power
limit; ``--out`` also writes everything as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_sweep"

# name -> {tile constant of flash_attention.cu: value}
VARIANTS = {
    "chosen": {},
    "fwd_bn16": {"kFwdBN": 16},
    "fwd_bn64": {"kFwdBN": 64},
    "dq_bn32": {"kDqBN": 32},
    "dkdv_bq32": {"kDkdvBQ": 32},
    "unroll1": {"kJU": 1},
}
CHECK_CASES = ((4, 1024, 10, 10, 128, None), (2, 200, 4, 2, 64, None),
               (1, 300, 2, 2, 128, 16), (3, 45, 4, 2, 16, None))
TIME_SHAPES = ((4, 1024, 10, 128), (8, 128, 10, 128))

MMA_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Each warp runs `iters` rounds of 8 independent mma.sync products.
__global__ void mma_loop(float* out, int iters, int kind) {
  float c[8][4];
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const uint32_t one = kind == 0 ? 0x3f800000u : 0x3f803f80u;  // 1.0 (tf32 / 2 x bf16)
  const uint32_t a0 = one, a1 = one, a2 = one, a3 = one, b0 = one, b1 = one;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kind == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(int kind, int blocks, int threads, int iters,
                        float* out, void* stream) {
  mma_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters, kind);
  return static_cast<int>(cudaGetLastError());
}
"""


def make_copy(name, tiles):
    """``src/repro_torch`` copied to OUT/name/src with ``tiles`` set."""
    dst = OUT / name / "src" / "repro_torch"
    shutil.rmtree(OUT / name, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "kernels" / "csrc" / "flash_attention.cu"
    text = cu.read_text()
    for const, value in tiles.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{const} not found once in {cu}")
    cu.write_text(text)
    return OUT / name


def ptxas_report(text):
    """{kernel: "N registers, S B stack, P B spill stores"}."""
    rows, name, frame = {}, None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for \S*?(flash_(?:fwd|bwd_dq|bwd_dkdv"
                      r"|bwd_delta)_kernel)I(\w+?)E+v", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            frame = f"{m.group(1)} B stack, {m.group(2)} B spill stores"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name] = f"{m.group(1)} registers, {frame}"
            name = None
    return rows


def check(torch, cs):
    """Every flash output within chip_smoke's flash tolerances of its
    plain version, over CHECK_CASES, f32 and bf16?"""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fp8_plain,
        flash_attention_plain, flash_bwd, flash_fwd)
    ok = True
    for dtype in ("float32", "bfloat16"):
        for B, S, H, KV, D, window in CHECK_CASES:
            q, k, v, do = cs.flash_inputs(torch, B=B, S=S, H=H, KV=KV, D=D,
                                          dtype=dtype, seed=S + D)
            o, lse = flash_fwd(q, k, v, window=window)
            o_ref, lse_ref = flash_attention_plain(q, k, v, True, window)
            got = flash_bwd(q, k, v, o_ref, lse_ref, do, window=window)
            want = flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do,
                                             True, window)
            of, _ = flash_fwd(q, k, v, window=window, fp8=True)
            of_ref, _ = flash_attention_fp8_plain(q, k, v, True, window)
            torch.cuda.synchronize()
            ok &= cs.max_err(torch, o, o_ref)[1]
            ok &= cs.scalar_gate(float((lse - lse_ref).abs().max()), 1e-4,
                                 1e-5, float(lse_ref.abs().max()))[0]
            ok &= all(cs.max_err(torch, a, b, tol=cs.TOL_FLASH_BWD)[1]
                      for a, b in zip(got, want))
            ok &= cs.max_err(torch, of, of_ref)[1]
    return ok


def timings(torch, cs):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import flash_bwd, flash_fwd
    res = {}
    for B, S, H, D in TIME_SHAPES:
        q, k, v, do = cs.flash_inputs(torch, B=B, S=S, H=H, KV=H, D=D)
        o, lse = flash_fwd(q, k, v)
        r = {"fwd_ms": cs.time_ms(torch, lambda: flash_fwd(q, k, v)),
             "fwd_fp8_ms": cs.time_ms(
                 torch, lambda: flash_fwd(q, k, v, fp8=True)),
             "bwd_ms": cs.time_ms(
                 torch, lambda: flash_bwd(q, k, v, o, lse, do))}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flash_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()
        r["bwd_parts_us"] = {
            name.split("<")[0].split("::")[-1]: us / 5 for name, us in
            cs.device_time_by_kernel(torch, prof).items() if "flash" in name}
        res[f"B{B}_S{S}"] = r
    return res


def variant(copy: Path, build_only: bool) -> int:
    """In a child process: build the copy's flash library (printing
    ptxas's report), or check and time it (printing one JSON line)."""
    sys.path[:0] = [str(copy / "src"), str(ROOT)]
    import torch
    from repro_torch.kernels import _build
    if build_only:
        print(_build.build(["flash_attention"], verbose=True))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    print(json.dumps({"ok": check(torch, cs), "timing": timings(torch, cs)}))
    return 0


def mma_rates(torch, lib_path):
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.mma_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 8 * sms, 128, 4096
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for kind, name, flop in ((0, "mma.sync m16n8k8 tf32", 2 * 16 * 8 * 8),
                             (1, "mma.sync m16n8k16 bf16", 2 * 16 * 8 * 16)):
        for _ in range(2):                       # warm up
            assert lib.mma_rate(kind, blocks, threads, 16, out.data_ptr(),
                                stream) == 0
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        assert lib.mma_rate(kind, blocks, threads, iters, out.data_ptr(),
                            stream) == 0
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        mmas = blocks * threads // 32 * iters * 8
        rates[name] = {"ms": ms, "tflops": mmas * flop / ms / 1e9}
    return rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.variant:
        return variant(Path(args.variant), args.build_only)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("flash_sweep: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    copies = {name: make_copy(name, tiles) for name, tiles in VARIANTS.items()}
    mma_src = OUT / "mma_rate.cu"
    mma_src.write_text(MMA_SRC)
    me = [sys.executable, str(Path(__file__).resolve())]
    builds = {name: subprocess.Popen(
        me + ["--variant", str(path), "--build-only"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, path in copies.items()}
    builds["mma_rate"] = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / "mma_rate.so"),
         str(mma_src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    logs = {name: p.communicate()[0] for name, p in builds.items()}
    failed = [n for n, p in builds.items() if p.returncode]
    if failed:
        for n in failed:
            print(f"build failed for {n}:\n{logs[n][-4000:]}", file=sys.stderr)
        return 1
    report = {"gpu": cs.gpu_line(), "variants": {}}
    for name, path in copies.items():
        run = subprocess.run(me + ["--variant", str(path)],
                             capture_output=True, text=True)
        if run.returncode:
            print(f"{name} failed:\n{run.stderr[-4000:]}", file=sys.stderr)
            return 1
        entry = dict(json.loads(run.stdout.strip().splitlines()[-1]),
                     tiles=VARIANTS[name], ptxas=ptxas_report(logs[name]))
        report["variants"][name] = entry
        print(f"{name:10s} ok={entry['ok']} " + json.dumps(entry["timing"]),
              flush=True)
        for kern, line in entry["ptxas"].items():
            if "Li128" in kern:                 # the main path's head dim
                print(f"    {kern}: {line}")
    report["mma_rate"] = mma_rates(torch, OUT / "mma_rate.so")
    for name, r in report["mma_rate"].items():
        print(f"{name}: {r['tflops']:.1f} TFLOP/s ({r['ms']:.3f} ms)")
    print(report["gpu"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if all(v["ok"] for v in report["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
