"""The readings that a cell's limits are set from, on a card.

    python3 benchmark/calibrate.py --workload <cell> --mode <mode> \
        --seeds 1,2,3 [--seconds 2] [--out FILE]

modes:
  sound       the cell's run as the benchmark makes it (a short window),
              its compared numbers: the lower readings
  control     the plain reference computed in the precision below the
              configuration's (float8 e4m3 for bfloat16) in the program's
              place: the upper readings
  <fault>     a fault planted under the timed path (the generator names the
              faults it can plant), e.g. half_batch, unchanged

All seeds run in one process, one after the other; each prints one JSON
line {"seed", "mode", "numbers"} (and appends it to ``--out``). The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402
from harness import env  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    env.prepare_environment(run.ROOT)
    if args.mode == "control":
        # two references side by side, one with float8 copies: keep the
        # allocator's free blocks usable (the program is not run here)
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    cell = run.Cell(run.ROOT, args.workload)
    device = run.open_card(cell, env.Phases(time.perf_counter()))
    if device is None:
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        phases = env.Phases(time.perf_counter())
        torch.cuda.reset_peak_memory_stats(device)
        res = run.run_cell(cell, run.seed_of(seed), args.seconds, False,
                           device, phases,
                           control=args.mode == "control",
                           plant=None if args.mode in ("sound", "control")
                           else args.mode)
        line = {"workload": args.workload, "seed": seed, "mode": args.mode,
                "numbers": (res["checks"] if "checks" in res
                            else res["numbers"])}
        if "checks" in res:
            line["correct"] = res["correct"]
            line["numbers"] = res["_log"]["numbers"]
            line["memory_peak_bytes"] = res["device"]["memory_peak_bytes"]
            line["metrics"] = res["metrics"]
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del res
        run.gc.collect()
        torch.cuda.empty_cache()
    bad = env.forbidden_modules()
    if bad:
        env.log("forbidden modules loaded: " + ", ".join(bad))
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
