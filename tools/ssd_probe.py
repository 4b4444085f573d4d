#!/usr/bin/env python3
"""Variants and per-kernel device time of the SSD chunk scan.

    python3 tools/ssd_probe.py [--out ssd_probe.json]

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc.

1. Each variant of ``VARIANTS`` is a copy of ``src/repro_torch`` under
   ``build/ssd_probe/<name>/`` whose ``csrc/ssd.cu`` has a few lines
   replaced; "chosen" is the source as committed.  Design alternatives:
   C.B^T with its three products accumulated straight into the running
   sum (no per-k-step sums), L_ij by ``expf`` in place of ``exp2f``, and
   three CTAs an SM in place of four.  Diagnostics, whose outputs are
   wrong by design and only timed: the scan without its intra product,
   without its inter product, and every kernel staging only its first
   two k tiles (the rest of its loads skipped).  Every copy builds its
   own library, all at once, with ptxas's report.
2. A child process per variant imports its copy, holds ``ssd`` against
   ``ssd_chunked`` at ``chip_smoke.SSD_CASES`` (f32 and bf16; the worst
   ratio of error to ``TOL_SSD``'s allowance), then times it at
   ``chip_smoke.SSD_TIMING_SHAPES`` (CUDA events, L2 flushed,
   ``chip_smoke.time_ms``) with each of its four kernels' device time
   (torch.profiler, L2 warm, 10 calls).

Prints one line per variant, then the card's name and power limit;
``--out`` also writes everything as JSON.  Exits nonzero if the
committed source ("chosen") fails its check; the alternatives' ratios
are reported (C.B^T in one running sum is expected to exceed 1).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ssd_probe"
KERNEL = r"ssd_(?:cb|state|pass|scan)_kernel"

# name -> [(text of csrc/ssd.cu, its replacement, occurrences)]
VARIANTS = {
    "chosen": [],
    "cb_one_sum": [(
        "        float part[4] = {0.f, 0.f, 0.f, 0.f};\n"
        "        mma_split<false>(part, a, bb);\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < 4; ++e) acc[e] += part[e];",
        "        mma_split<false>(acc, a, bb);", 1)],
    "expf": [("exp2f((cum[i] - cum[j]) * kLog2e)", "expf(cum[i] - cum[j])",
              1)],
    "three_ctas": [("__launch_bounds__(kThreads, 4)",
                    "__launch_bounds__(kThreads, 3)", 2)],
    "diag_no_intra": [("        if (jk >= r) break;",
                       "        if (jk >= r || kc >= 0) break;", 1)],
    "diag_no_inter": [("        if (n0 + k0 >= p.N) break;\n        Tf a[2][4];",
                       "        if (n0 + k0 >= p.N || kc >= 0) break;\n"
                       "        Tf a[2][4];", 1)],
    "diag_first_tiles": [("    if (kc + 1 < nk) stage(kc + 1, s ^ 1);",
                          "    if (kc + 1 < nk && kc < 1) stage(kc + 1, s ^ 1);",
                          2)],
}


def make_copy(name, edits):
    """``src/repro_torch`` copied to OUT/name/src with ``edits`` made."""
    dst = OUT / name / "src" / "repro_torch"
    shutil.rmtree(OUT / name, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "kernels" / "csrc" / "ssd.cu"
    text = cu.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"{name}: {old!r} not found {count} times")
        text = text.replace(old, new)
    cu.write_text(text)
    return OUT / name


def ptxas_report(text):
    """{kernel: "N registers, S B stack, P B spill stores"}."""
    rows, name, frame = {}, None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for \S*?(ssd_(?:cb|state|pass|scan)"
                      r"_kernel)(?:I(\w+?)E)?E", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m:
            frame = f"{m.group(1)} B stack, {m.group(2)} B spill stores"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name] = f"{m.group(1)} registers, {frame}"
            name = None
    return rows


def check(torch, cs):
    """The worst ratio of error to TOL_SSD's allowance over SSD_CASES, f32
    and bf16 (y and the final state)."""
    from repro_torch.kernels.ssd import ssd, ssd_chunked
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        for B, S, H, P, N, chunk in cs.SSD_CASES:
            args = cs.ssd_case(torch, B, S, H, P, N, seed=S)
            args[0] = args[0].to(getattr(torch, dtype))
            y, h = ssd(*args, chunk=chunk)
            yp, hp = ssd_chunked(*args, chunk=chunk)
            torch.cuda.synchronize()
            for got, want in ((y, yp), (h, hp)):
                ratio = cs.max_err(torch, got, want, tol=cs.TOL_SSD)[2]
                worst = max(worst, ratio if ratio == ratio else float("inf"))
    return worst


def timings(torch, cs):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd import ssd
    res = {}
    for key, (B, S, H, P, N, Q) in cs.SSD_TIMING_SHAPES.items():
        args = cs.ssd_case(torch, B, S, H, P, N, seed=S)
        r = {"ms": cs.time_ms(torch, lambda: ssd(*args, chunk=Q), reps=30)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                ssd(*args, chunk=Q)
            torch.cuda.synchronize()
        r["kernels_us"] = {
            re.search(KERNEL, name).group(0): us / 10
            for name, us in cs.device_time_by_kernel(torch, prof).items()
            if re.search(KERNEL, name)}
        res[key] = r
    return res


def variant(copy: Path, build_only: bool) -> int:
    """In a child process: build the copy's SSD library (printing ptxas's
    report), or check and time it (printing one JSON line)."""
    sys.path[:0] = [str(copy / "src"), str(ROOT)]
    import torch
    from repro_torch.kernels import _build
    if build_only:
        print(_build.build(["ssd"], verbose=True))
        return 0
    import chip_smoke as cs
    print(json.dumps({"worst_gate_ratio": check(torch, cs),
                      "timing": timings(torch, cs)}))
    return 0


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
        print("ssd_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    copies = {name: make_copy(name, edits) for name, edits in VARIANTS.items()}
    me = [sys.executable, str(Path(__file__).resolve())]
    builds = {name: subprocess.Popen(
        me + ["--variant", str(path), "--build-only"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, path in copies.items()}
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
                     ptxas=ptxas_report(logs[name]))
        report["variants"][name] = entry
        print(f"{name:17s} worst_gate_ratio={entry['worst_gate_ratio']:.4g} "
              + json.dumps(entry["timing"]), flush=True)
        for kern, line in entry["ptxas"].items():
            print(f"    {kern}: {line}")
    print(report["gpu"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if report["variants"]["chosen"]["worst_gate_ratio"] <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
