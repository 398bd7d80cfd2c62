"""Readings of the output check's numbers, for setting its limits: the
program's on many seeds, and the lower-precision control's (the
reference's solve in bfloat16 in the program's place) on the same rows.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 4

runs, per seed and in one process, the cell's set-up, a short window at
the cell's own load and the check with the control, and prints one JSON
line per seed: {"seed", "program": {...}, "control": {...}}. The
benchmark's own runs do not run the control.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell_name, seeds, seconds, device, cfg=None, traffic=None):
    """Yield (seed, program numbers, control numbers) per seed."""
    from portbench.harness.main import Session, load_cell

    _, _, cfg0, traffic0, _ = load_cell(cell_name)
    for seed in seeds:
        s = Session(cfg or cfg0, traffic or traffic0, seed, device)
        s.warm()
        s.measure(seconds)
        s.release()
        prog, ctrl = s.check(control=True)
        yield seed, prog, ctrl


def main(argv):
    import argparse

    sys.path.insert(0, ROOT)
    from portbench.harness import set_environment

    set_environment(ROOT)
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(x) for x in args.seeds.split(",")]
    for seed, prog, ctrl in readings(args.workload, seeds, args.seconds,
                                     torch.device("cuda", 0)):
        print(json.dumps({"cell": args.workload, "seed": seed, "program": prog,
                          "control": ctrl, "t": time.time()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
