"""AOT serving artifact demo on the PyTorch port: trace once, ship the
program.

Exports the packed DWA solver as a hermetic artifact file
(``torch.export``), then plays the serving side: reads the header
without deserializing, loads the artifact, and runs a solve (one static
obstacle sweep, through the kernel's registered operator), with
semantics pinned at export time.

Run: python examples_torch/aot_artifact_demo.py [--device cpu]
"""

import argparse
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kompass_core_tpu_torch.benchmark.runner import parse_device_args  # noqa: E402
from kompass_core_tpu_torch.ops.solver import (  # noqa: E402
    SolverSpec,
    pack_solver_input,
    packed_input_size,
    unpack_solver_output,
)
from kompass_core_tpu_torch.ops.window import sample_velocity_window  # noqa: E402
from kompass_core_tpu_torch.serving import (  # noqa: E402
    export_packed_solver,
    load_packed_solver,
    read_artifact_header,
)


SERVE_TIMED = 20  # served solves timed after the demo's one, when asked


def run(device, timings=None):
    """Export the packed solver traced on ``device``, load it there and
    serve one solve; returns the outcome figures (header fields, the
    artifact's size and path, the solve's found flag and cost).
    ``timings``, a dict, receives the median ms of 20 more served solves,
    each to its output on the host."""
    spec = SolverSpec(
        is_omni=False, n_vx=9, n_vy=1, n_omega=9, max_points=20,
        num_ctrl_points=2, scan_size=64, seg_size=64,
    )
    with tempfile.TemporaryDirectory(prefix="kompass_aot_") as tmp:
        path = os.path.join(tmp, "dwa_solver.ktpuart")

        # ---- build side (CI, release pipeline) ----
        header = export_packed_solver(spec, path, device=device)
        size_kb = os.path.getsize(path) / 1024

        # ---- serving side ----
        scan_slots = read_artifact_header(path)["meta"]["solver_spec"]["scan_size"]
        art, spec2 = load_packed_solver(path, device=device)

    limits = np.zeros(9, np.float32)
    limits[0:3] = (1.0, 5.0, 10.0)
    limits[6:9] = (2.0, 3.0, 3.0)
    window = sample_velocity_window((0.3, 0.0, 0.0), limits, 0.1, 9, 1, 9,
                                    False)
    n_seg = 50
    seg_x = np.full(64, 1e8, np.float32)
    seg_x[:n_seg] = np.linspace(0, 4.9, n_seg)
    seg_y = np.full(64, 1e8, np.float32)
    seg_y[:n_seg] = 0.0
    seg_arc = np.zeros(64, np.float32)
    seg_arc[:n_seg] = np.linspace(0, 4.9, n_seg)
    obs = np.full((64, 2), 1e8, np.float32)
    obs[0] = [2.0, 0.4]
    params = np.array(
        [0.1, 0.2, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0, 3.0, 10 / 3],
        np.float32,
    )
    buf = np.zeros(packed_input_size(spec2), np.float32)
    pack_solver_input(
        spec2, buf, params_vec=params, state=(0.0, 0.0, 0.0), window=window,
        obs_xy=obs, obs_count=1, seg_x=seg_x, seg_y=seg_y, seg_arc=seg_arc,
        seg_count=n_seg, seg_total_len=4.9, ref_total_len=4.9,
        active_points=20,
    )
    out = unpack_solver_output(spec2, art.call(buf).cpu().numpy())
    if timings is not None:
        times = []
        for _ in range(SERVE_TIMED):
            t0 = time.perf_counter()
            art.call(buf).cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        timings["served_solve_ms"] = statistics.median(times)
    return {"kind": header["kind"], "path": path, "size_kb": size_kb,
            "platforms": header["platforms"], "torch": header["torch_version"],
            "scan_slots": scan_slots, "found": bool(out[0]),
            "cost": float(out[1])}


def lines(r):
    """The JAX demo's outcome lines for the figures ``r`` (``torch`` and
    its version where JAX prints ``jax`` and its own)."""
    return [
        f"exported {r['kind']} -> {r['path']} ({r['size_kb']:.0f} KiB, "
        f"platforms={r['platforms']}, torch {r['torch']})",
        f"header (no torch deserialization): {r['scan_slots']} scan slots",
        f"served solve: found={r['found']} cost={r['cost']:.4f}",
    ]


def main(argv=None):
    device, _ = parse_device_args(
        argparse.ArgumentParser(prog="aot_artifact_demo.py"), argv)
    for line in lines(run(device)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
