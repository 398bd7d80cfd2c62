"""Planner benchmark: every reference-bound geometric planner on the
recorded turtlebot map, mirroring the reference's ``test_ompl.py`` run
whose output is committed at
``tests/resources/reference/ompl/test_results_geometric_ref.csv``
(columns: method, solved, solution_time, solution_len, ...).

Counterpart of ``kompass_core_tpu/benchmark/planner_bench.py``, on an
explicit device: per planner solved / solve seconds / solution length
next to the reference's recorded length for the same (map, start, goal),
and the length ratio. Lengths are comparable (same problem); times are
not (different hardware and algorithms). The first solve of each planner
includes the capture of its scans' CUDA graphs.

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.planner_bench
--device cuda [--out PATH]``: it prints the summary and writes it to
PATH only when given one.
"""

import csv
import json
import os
import sys
import time

import numpy as np

RESOURCES = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests", "resources",
    "reference", "ompl",
)
ROBOT = (0.1, 0.4)  # cylinder radius, height
START = (-1.88, -0.38, 0.3)
GOAL = (0.59, 0.73, 0.0)
CONFIG = dict(num_samples=512, seed=2, connection_radius=1.5,
              max_iterations=1024, step_size=0.3, planning_timeout=30.0)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def problem():
    """(map meta, obstacle cloud, {planner id: the reference's CSV row})."""
    with open(os.path.join(RESOURCES, "map_meta.json")) as f:
        map_meta = json.load(f)
    map_cloud = np.load(os.path.join(RESOURCES, "turtlebot_map.npy"))
    ref_rows = {}
    with open(os.path.join(RESOURCES, "test_results_geometric_ref.csv")) as f:
        for row in csv.DictReader(f):
            ref_rows[row["method"].rsplit(".", 1)[-1]] = row
    return map_meta, map_cloud, ref_rows


def main(device, out_path=None, planner_ids=None):
    """Solve the problem with each reference planner (or
    ``planner_ids``) on ``device``; print the summary, and write it to
    ``out_path`` when given one."""
    from ..models import Robot, RobotGeometry, RobotType
    from ..planning import GlobalPlanner, GlobalPlannerConfig

    map_meta, map_cloud, ref_rows = problem()
    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.CYLINDER,
        geometry_params=np.array(ROBOT),
    )

    results = []
    for name, ref in ref_rows.items():
        if planner_ids is not None and name not in planner_ids:
            continue
        planner = GlobalPlanner(
            robot, config=GlobalPlannerConfig(planner_id=name, **CONFIG),
            device=device)
        planner.setup_problem(map_meta, *START, *GOAL, map_cloud)
        t0 = time.monotonic()
        path = planner.solve()
        dt = time.monotonic() - t0
        # the reference's own run failed some planners (e.g. LazyPRM:
        # solved=False, len 0.0) — no length to compare there
        ref_len = float(ref["solution_len"])
        ref_solved = ref["solved"].strip().lower() == "true" and ref_len > 0
        row = {
            "planner": name,
            "solved": path is not None,
            "solution_time_s": dt,
            "solution_len": planner.path_cost if path is not None else None,
            "ref_solved": ref_solved,
            "ref_solution_len": ref_len if ref_solved else None,
            "len_ratio_vs_ref": planner.path_cost / ref_len
            if (path is not None and ref_solved) else None,
        }
        results.append(row)
        log(f"{name}: solved={row['solved']} {dt:.2f}s "
            f"len={row['solution_len']} (ref {row['ref_solution_len']})")

    solved = [r for r in results if r["solved"]]
    ratios = [r["len_ratio_vs_ref"] for r in solved
              if r["len_ratio_vs_ref"] is not None]
    summary = {
        "workload": "turtlebot map, start (-1.88,-0.38) goal (0.59,0.73), "
                    "reference test_ompl.py problem",
        "device": str(device),
        "note": "solution_len comparable to the reference (same problem); "
                "times are different hardware/algorithms (the first solve "
                "includes the graph capture)",
        "planners_total": len(results),
        "planners_solved": len(solved),
        "planners_ref_solved": sum(r["ref_solved"] for r in results),
        # None (JSON null) when no solved planner has a reference
        # counterpart — np.median([]) is NaN, which is invalid JSON
        "median_len_ratio_vs_ref": (
            float(np.median(ratios)) if len(ratios) else None
        ),
        "results": results,
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--out", default=None)
    _device, _args = parse_device_args(_parser)
    main(_device, _args.out)
