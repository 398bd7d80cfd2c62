"""Times two checkouts of this repository against each other on one card.

    python3 chip_ab.py A_TREE B_TREE
    python3 chip_ab.py --points

Runs timed phases in turns A, B, B, A, A, B, B, A, each turn a fresh
process started in its tree's root that builds and imports that tree's
kernels and package: the 64-robot fleet tick with 8 tracked movers and
without, K3 against its plain version, the mapper update (Bayesian and
plain), K5 against its plain version, the 64-robot Bayesian fleet
mapper, the 64-scenario fleet solver per backend and the cost
evaluator, the static sweeps at their path shapes (K1 at three, K2, K4
and K6 at two each), the 64-robot k = 8 loop per tick, replayed and
eager, per backend, and K6, K7 and K8 at the k-tick loop's shape
(``phase_fleet_times``, ``phase_mapping_times``,
``phase_solver_times``, ``phase_static_times``, ``phase_ticks_times``
and ``phase_tpu_forms_times``). Every turn runs these phases from this script's
own ``chip_smoke.py``, one ruler for both trees: they call only the
package's entry points and the kernels' wrappers. Two versions are
compared only inside one such call: the card, its power limit and its
host's load differ between calls.

A tree is a checkout, for example the parent commit unpacked with
``git archive <commit> | tar -x -C ab/parent`` (``ab/`` is gitignored).
Prints every timing line, tagged with its tree and turn; exits non-zero
if a turn fails, or when there is no CUDA device.

``--points`` instead runs ``chip_smoke.phase_points_times`` once in this
checkout: the static sweeps (K1, K2, K4, K6) at each samples per thread
their kernel takes, at each of their path shapes, and their host enqueue
time per launch.
"""

import subprocess
import sys
from pathlib import Path

# argv[1]: the ruler, this script's own chip_smoke.py
TURN = (
    "import importlib.util, sys, torch\n"
    "from kompass_core_tpu_torch.ops import kernels\n"
    "assert torch.cuda.is_available(), 'no CUDA device'\n"
    "kernels.build_library()\n"
    "spec = importlib.util.spec_from_file_location('ruler', sys.argv[1])\n"
    "ruler = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(ruler)\n"
    "card, device = ruler.card_line(), torch.device('cuda')\n"
    "ruler.phase_fleet_times(kernels, device, card)\n"
    "ruler.phase_mapping_times(kernels, device, card)\n"
    "ruler.phase_solver_times(kernels, device, card)\n"
    "ruler.phase_static_times(kernels, device, card)\n"
    "ruler.phase_ticks_times(device, card)\n"
    "ruler.phase_tpu_forms_times(kernels, device, card)\n"
)
TIMING_WORDS = ("fleet tick", "fused_min_dist_sq_moving", "update_from_scan",
                "scan_to_grid_cells", "fleet mapper", "fleet solver", "cost evaluator,",
                "(K1)", "(K2)", "(K4)", "(K6)", "(K7)", "(K8)", "k-tick loop")
RULER = Path(__file__).resolve().with_name("chip_smoke.py")


def points() -> int:
    import torch

    import chip_smoke
    from kompass_core_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    kernels.build_library()
    chip_smoke.phase_points_times(kernels, torch.device("cuda"), chip_smoke.card_line())
    return 0


def main() -> int:
    if sys.argv[1:] == ["--points"]:
        return points()
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1:]
    for turn, tree in enumerate((a, b, b, a, a, b, b, a)):
        proc = subprocess.run([sys.executable, "-c", TURN, str(RULER)], cwd=tree,
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
