"""Times two checkouts of this repository against each other on one card.

    python3 chip_ab.py A_TREE B_TREE

Runs the timed phases of each tree's own ``chip_smoke.py`` in turns A, B,
B, A, A, B, B, A, each turn a fresh process started in its tree's root
that builds that tree's kernels: the 64-robot fleet tick with 8 tracked
movers and without, K3 against its plain version, the mapper update
(Bayesian and plain), K5 against its plain version and the 64-robot
Bayesian fleet mapper (``phase_fleet_times`` and ``phase_mapping_times``).
Two versions are compared only inside one such call: the card, its power
limit and its host's load differ between calls.

A tree is a checkout, for example the parent commit unpacked with
``git archive <commit> | tar -x -C ab/parent`` (``ab/`` is gitignored).
Prints every timing line, tagged with its tree and turn; exits non-zero
if a turn fails, or when there is no CUDA device.
"""

import subprocess
import sys

TURN = (
    "import torch, chip_smoke as c\n"
    "from kompass_core_tpu_torch.ops import kernels\n"
    "assert torch.cuda.is_available(), 'no CUDA device'\n"
    "kernels.build_library()\n"
    "card, device = c.card_line(), torch.device('cuda')\n"
    "c.phase_fleet_times(kernels, device, card)\n"
    "c.phase_mapping_times(kernels, device, card)\n"
)
TIMING_WORDS = ("fleet tick", "fused_min_dist_sq_moving", "update_from_scan",
                "scan_to_grid_cells", "fleet mapper")


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    for turn, tree in enumerate((a, b, b, a, a, b, b, a)):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"[{tree} turn {turn}] failed:\n{proc.stdout}{proc.stderr}",
                  file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if any(word in line for word in TIMING_WORDS):
                print(f"[{tree} turn {turn}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
