#!/usr/bin/env python3
"""Readings that the check's limits are set from, on the card:

    python3 slambench/control.py --workload <cell> --seeds 1,2,3 --seconds 40 [--control]

Runs the cell once per seed in this process, as run.py does, and prints one
JSON line per seed with every number the check compares. Without
`--control` these are the program's own readings (the lower ones). With
`--control` the stage numbers are those of the reference computed in
bfloat16, the next precision below the float32 the configuration states,
put in the program's place (the upper readings). The benchmark's runs never
run this.
"""

import argparse
import json
import os
import sys
import types

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from slambench import testing
    from slambench.lib import check, spec

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 3
    run = testing.load_run_module()
    c = spec.cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    stage = check.stage_numbers

    def stage_with_control(cap, cfg, text_on, control=False):
        nums = stage(cap, cfg, text_on)
        if args.control:
            low = stage(cap, cfg, text_on, control=True)
            nums.update({k: v for k, v in low.items() if not k.endswith(("_calls", "_checked"))})
        return nums

    check.stage_numbers = stage_with_control
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run(types.SimpleNamespace(seed=seed, seconds=args.seconds, trace=0), c)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "attempted": res["attempted"], "failed": res["failed"],
                          "last_frame": res["last_frame"], "numbers": res["numbers"]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
