"""Hold the port's workflows (``examples_torch/``) against the JAX demos
(``examples/``) on the CPU.

``start_jax_demo`` runs an unmodified JAX demo in a subprocess with XLA's
CPU backend emitting no FMA (the port's production forms round each
operation as that build does), ``finish`` waits for it and returns its
standard output, and ``figures`` parses a demo's outcome lines, printed
by the JAX demo or made by the port's ``lines(run(...))``, into the keys
of the port's ``run`` dict, each value the string as printed. A test
compares the two parses; ``EXCLUDED`` names the figures left out of the
comparison and why. This module imports neither jax nor the JAX package.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# XLA's CPU backend without FMA (``test_torch_kernels.NO_FMA``), on the
# virtual 8-device CPU mesh the JAX demos' meshes span
JAX_XLA_FLAGS = "--xla_force_host_platform_device_count=8 --xla_cpu_max_isa=SSE4_2"
JAX_DEMO_TIMEOUT = 240  # seconds per JAX demo

_NUM = r"[-+]?[\d.]+"

# per demo: (pattern, list key or None). A pattern's named groups are
# keys of the port's run() dict; with a list key, each match is one entry
# (a dict) of the run dict's list under that key.
PATTERNS = {
    "full_stack_demo": [
        (rf"\[plan\] (?P<waypoints>\d+) waypoints, cost (?P<path_cost>{_NUM}) m", None),
        (rf"\[follow\] reached=(?P<reached>\w+) steps=(?P<steps>\d+) "
         rf"final=\((?P<final_x>{_NUM}),(?P<final_y>{_NUM})\)", None),
        (r"\[map\] occupied cells in last egocentric grid: (?P<occupied>\d+)", None),
        (rf"\[estop\] min slowdown factor seen: (?P<min_slowdown>{_NUM})", None),
        (rf"\[demo\] wall clock (?P<wall_s>{_NUM}) s", None),
    ],
    "dynamic_world_demo": [
        (rf"t=\s*(?P<t>{_NUM})s robot=\(\s*(?P<x>{_NUM}),\s*(?P<y>{_NUM})\) "
         rf"ped=\(\s*(?P<ped_x>{_NUM}),\s*(?P<ped_y>{_NUM})\) "
         rf"est_v=\((?P<est_vx>{_NUM}),(?P<est_vy>{_NUM})\) vx=(?P<vx>{_NUM})", "trace"),
        (rf"goal reached at tick (?P<goal_tick>\d+); min pedestrian clearance "
         rf"(?P<min_clearance>{_NUM}) m", None),
    ],
    "rtt_amortized_serving_demo": [
        (rf"single-tick serving :\s*(?P<single_ms>{_NUM}) ms/tick", None),
        (rf"k=\d+\s+tick serving :\s*(?P<k_ms>{_NUM}) ms/tick", None),
        (r"commands per round trip: vx=(?P<vx>\[[^\]]*\])", None),
    ],
    "aot_artifact_demo": [
        (r"exported (?P<kind>\w+) -> (?P<path>\S+) \((?P<size_kb>\d+) KiB, "
         r"platforms=(?P<platforms>\[[^\]]*\]), (?:jax|torch) (?P<torch>\S+)\)", None),
        (r"header \(no (?:jax|torch) deserialization\): (?P<scan_slots>\d+) scan slots",
         None),
        (rf"served solve: found=(?P<found>\w+) cost=(?P<cost>{_NUM})", None),
    ],
    "vision_follow_demo": [
        (rf"\[rgb\] off-center target recentred: orientation error "
         rf"(?P<error_first>{_NUM}) -> (?P<error_last>{_NUM}) \(omega now "
         rf"(?P<omega>{_NUM})\)", None),
        (r"\[rgb\] target lost -> search state machine issued "
         r"(?P<search_commands>\d+) rotate/pause", None),
        (rf"\[rgbd\] distance to target (?P<distance_first>{_NUM}) m -> "
         rf"(?P<distance_last>{_NUM}) m \(standoff (?P<standoff>{_NUM}) m\)", None),
    ],
    "offline_pipeline_demo": [
        (r"artifacts -> (?P<out_dir>\S+)", None),
        (rf"recorded (?P<recorded>\d+) path points, total length (?P<length>{_NUM}) m",
         None),
        (r"reloaded (?P<reloaded>\d+) points from XML", None),
        (rf"fitted model: x_dot_prop_vx=(?P<x_dot_prop_vx>{_NUM}) \(true 0.92\), "
         rf"yaw_dot_prop=(?P<yaw_dot_prop>{_NUM})", None),
        (rf"replay RMS position error: (?P<rms>{_NUM}) m", None),
        (rf"Stanley on half-circle: reached=(?P<reached>\w+), mean lateral error "
         rf"(?P<lateral_error>{_NUM}) m, time-to-goal (?P<time_to_goal>{_NUM}) s", None),
        (r"PCD grid (?P<grid_shape>\([^)]*\)): (?P<occupied>\d+) occupied / "
         r"(?P<free>\d+) free cells, origin (?P<origin>\[[^\]]*\])", None),
    ],
    "fleet_demo": [
        (r"fleet\[(?P<mode>[\w-]+)\]: (?P<reached>\d+)/(?P<robots>\d+) robots "
         rf"reached goals in (?P<ticks>\d+) ticks(?:; steady tick (?P<steady_ms>{_NUM}) ms)?",
         None),
        (r"fleet\[peer-avoidance, (?P<where>[^\]]+)\]: (?P<reached>\d+)/(?P<robots>\d+) "
         rf"robots reached crossing goals in (?P<ticks>\d+) ticks; closest approach "
         rf"(?P<closest>{_NUM}) m \(contact = (?P<contact>{_NUM}) m\)", None),
    ],
    "serving_restart_demo": [
        (r"A served (?P<ticks>\d+) ticks, exported artifact \((?P<size_kb>\d+) KiB\)",
         None),
        (r"B inventory: kind=(?P<kind>\w+) robots=(?P<robots>\d+) "
         r"platforms=(?P<platforms>\[[^\]]*\])", None),
        (r"B's first post-restart commands: (?P<vx>\[[^\]]*\])", None),
        (r"bit-identical to A's next tick: (?P<same>\w+)", None),
    ],
    "serving_mesh_shard_demo": [
        (r"exported (?P<kind>\w+) for (?P<robots>\d+) robots -> (?P<path>\S+) "
         r"\((?P<bytes>\d+) bytes\)", None),
        (r"served (?P<served>\d+) robots across (?P<devices>\d+) devices", None),
    ],
}

# figures printed but not compared, by name, with the reason
_CONTAINER = "artifact size: torch.export's program, not StableHLO"
EXCLUDED = {
    "full_stack_demo": {"wall_s": "timing"},
    "rtt_amortized_serving_demo": {"single_ms": "timing", "k_ms": "timing"},
    "aot_artifact_demo": {"path": "temp path", "size_kb": _CONTAINER,
                          "torch": "version string"},
    "offline_pipeline_demo": {"out_dir": "temp path"},
    "fleet_demo": {"steady_ms": "timing"},
    "serving_restart_demo": {"size_kb": _CONTAINER},
    "serving_mesh_shard_demo": {"path": "temp path", "bytes": _CONTAINER},
}

# the line each JAX demo prints after its own assertions passed
PASSED = {
    "full_stack_demo": "FULL STACK DEMO PASSED",
    "dynamic_world_demo": "dynamic-world pipeline OK",
    "rtt_amortized_serving_demo": "commands per round trip",
    "aot_artifact_demo": "served solve: found=True",
    "vision_follow_demo": "VISION FOLLOW DEMO PASSED",
    "offline_pipeline_demo": "offline pipeline demo OK",
    "fleet_demo": "DEMO PASSED",
    "serving_restart_demo": "serving restart OK",
    "serving_mesh_shard_demo": "SERVING MESH SHARD DEMO PASSED",
}


def start_jax_demo(name, tmp_dir, args=(), script=None):
    """Start ``examples/<name>.py`` (or ``script``, a wrapper that runs it)
    with ``args`` on the CPU without FMA; ``tmp_dir`` becomes its TMPDIR
    and takes its standard error."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=JAX_XLA_FLAGS,
               PYTHONPATH=str(REPO), TMPDIR=str(tmp_dir))
    err_path = Path(tmp_dir) / "stderr.txt"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(script or REPO / "examples" / f"{name}.py"), *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    proc.err_path = err_path
    return proc


def finish(proc, name):
    """The standard output of a JAX demo started by ``start_jax_demo``,
    once it exited 0 after printing its pass line."""
    try:
        out, _ = proc.communicate(timeout=JAX_DEMO_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, (
        f"{name}: exit {proc.returncode}\n{out}\n{proc.err_path.read_text()[-3000:]}")
    assert PASSED[name] in out, out
    return out


def stop_all(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def figures(name, text):
    """The outcome figures of demo ``name`` in ``text`` (printed lines),
    as strings under the port's run() keys; every pattern must match."""
    found = {}
    for pattern, list_key in PATTERNS[name]:
        matches = [m.groupdict() for m in re.finditer(pattern, text)]
        if list_key is not None:
            assert matches, f"{name}: no line matches {pattern!r}\n{text}"
            found[list_key] = matches
        elif matches:
            assert len(matches) == 1, (pattern, matches)
            found.update({k: v for k, v in matches[0].items() if v is not None})
    return found


def compared(name, fig):
    """``fig`` without the figures ``EXCLUDED`` names for ``name``."""
    skip = EXCLUDED.get(name, {})
    return {k: v for k, v in fig.items() if k not in skip}


def assert_same_figures(name, jax_out, port_result, port_lines):
    """The JAX demo's printed figures equal the port's as printed, every
    parsed key is a key of the port's run() dict (or of its list's
    entries), and the JAX demo printed each figure of the run dict that
    a pattern names and that is compared."""
    jax_fig = figures(name, jax_out)
    port_fig = figures(name, "\n".join(port_lines))
    for key, val in port_fig.items():
        if isinstance(val, list):
            assert set(val[0]) <= set(port_result[key][0]), key
        else:
            assert key in port_result, key
    named = {g for pattern, _ in PATTERNS[name] for g in re.compile(pattern).groupindex}
    missing = (named & set(port_result)) - set(jax_fig) - set(EXCLUDED.get(name, {}))
    assert not missing, f"{name}: the JAX demo printed no {sorted(missing)}"
    want, got = compared(name, jax_fig), compared(name, port_fig)
    assert got == want, f"{name}: port {got} != JAX {want}"
    return jax_fig, port_fig
