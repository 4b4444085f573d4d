"""The port's dry-run CLI (the JAX package's ``launch/dryrun.py``): every
(architecture × input shape) on the single-pod (32 x 8) or the multi-pod
(2 x 32 x 8) production mesh of H100s, resolved without allocating or
compiling (``launch/dryrun_lib.py``): per-device argument bytes, the
analytic FLOPs and HBM bytes, the roofline term that binds; ``--outer``
the DiLoCo outer step's wire bytes per device across pods.

    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--json-out F]
    python -m repro_torch.launch.dryrun --outer --arch nanochat-d20 \\
        --delta-dtype int8

``--json-out`` writes the reference's format, which
``launch.comm_sim.load_calibration`` reads.  Host only, in seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default without "
                         "--arch / --shape)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--outer", action="store_true")
    ap.add_argument("--delta-dtype", type=str, default="float32")
    ap.add_argument("--profile", type=str, default="2d",
                    help="sharding profile: 2d|dp|dp_fsdp|attn_dp|"
                         "expert_parallel|seqpar|auto (auto = the "
                         "per-arch choice of auto_profile)")
    ap.add_argument("--json-out", type=str, default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCH_IDS
    from repro_torch.launch.dryrun_lib import (PROFILES, dryrun_combo,
                                               dryrun_outer_step)
    rules = ({"__auto__": True} if args.profile == "auto"
             else PROFILES[args.profile])
    results = []
    if args.outer:
        for a in [args.arch] if args.arch else ["nanochat-d20"]:
            results.append(dryrun_outer_step(a, delta_dtype=args.delta_dtype))
    else:
        archs = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(SHAPES)
        for a in archs:
            for s in shapes:
                results.append(dryrun_combo(a, s, multi_pod=args.multi_pod,
                                            rules=rules))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([dataclasses.asdict(r) for r in results], f, indent=1)
    print(f"[dryrun] {len(results)} combinations resolved", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
