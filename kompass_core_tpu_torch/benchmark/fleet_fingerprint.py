"""A fingerprint of the fleet tick's traced program: equal hashes across
two trees mean the traced tick is unchanged.

Counterpart of ``kompass_core_tpu/benchmark/fleet_fingerprint.py``, which
lowers the fleet-v2 tick to StableHLO from the tree given on its command
line, strips the location metadata and prints its SHA-256. Here the tick
is traced through the serving path (``serving/export.py::
trace_fleet_tick``, what ``export_fleet_tick`` writes): ``torch.export``
over fake tensors, so nothing is computed and no kernel launches; a
kernel appears in the graph as its registered operator
(``kompass_torch.fused_min_dist_sq`` for K1). The fleet is the JAX
script's, ``chunk_unroll_bench._setup_fleet``: 45 x 44 samples, 30 steps,
512 rays, ``n_robots`` robots, the zero input matrix. The graph's text
(``print_readable``: every node with its operator, arguments, shapes and
dtypes) is normalised (stack-trace comments, file paths, source
locations and trailing spaces dropped) and hashed.

``fingerprint(repo_root)`` traces the port of the tree at ``repo_root``
(this version or later: it runs that tree's copy of this module) in a
process of its own, so two trees' packages never meet in one
interpreter. Nothing runs at import.

Run: ``python -m kompass_core_tpu_torch.benchmark.fleet_fingerprint
<repo_root> [n_robots] [--device cpu]`` prints ``repo=... n=...
lines=...`` and ``torch_export_sha256=...`` (writes no file). The hash
depends on the device the tick is traced on; compare trees on one.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

_FILE_COMMENT = re.compile(r"^\s*#\s*(File:|No stacktrace found)")
_PATH = re.compile(r"(?:[A-Za-z]:)?(?:/[\w.\-]+)+\.py(?::\d+)?")


def normalise(text: str) -> str:
    """The graph text without stack-trace comments, file paths, source
    locations and trailing spaces."""
    lines = []
    for line in text.splitlines():
        if _FILE_COMMENT.match(line):
            continue
        lines.append(_PATH.sub("<source>", line).rstrip())
    return "\n".join(lines)


def trace_text(n_robots: int = 1024, horizon: int = 30, device="cpu") -> str:
    """The normalised text of the fleet tick's graph, traced on ``device``."""
    import torch

    from ..serving.export import trace_fleet_tick
    from .chunk_unroll_bench import _setup_fleet

    fleet = _setup_fleet(n_robots, 512, device=torch.device(device), horizon=horizon)
    program = trace_fleet_tick(fleet, device=device)
    return normalise(program.graph_module.print_readable(print_output=False))


_CHILD = (
    "import json, sys\n"
    "from kompass_core_tpu_torch.benchmark import fleet_fingerprint as f\n"
    "import kompass_core_tpu_torch as k\n"
    "print(json.dumps([k.__file__, f.trace_text(int(sys.argv[1]),"
    " device=sys.argv[2])]))\n"
)


def fingerprint(repo_root, n_robots: int = 1024, device="cpu"):
    """(lines, sha256) of the tick traced by the port of the tree at
    ``repo_root``, in a process of its own that imports that tree's
    package alone."""
    root = Path(repo_root).resolve()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(n_robots), str(device)],
        capture_output=True, text=True, cwd=root, env=env, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"tracing the tick of {root} failed:\n{proc.stderr}")
    package, text = json.loads(proc.stdout.strip().splitlines()[-1])
    if not Path(package).resolve().is_relative_to(root):
        raise RuntimeError(f"{root}'s trace imported the port from {package}")
    return len(text.splitlines()), hashlib.sha256(text.encode()).hexdigest()


def main(repo_root, n_robots: int = 1024, device="cpu"):
    lines, sha = fingerprint(repo_root, n_robots, device=device)
    print(f"repo={repo_root} n={n_robots} lines={lines}")
    print(f"torch_export_sha256={sha}")
    return lines, sha


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("repo_root")
    _parser.add_argument("n_robots", nargs="?", type=int, default=1024)
    _device, _args = parse_device_args(_parser)
    main(_args.repo_root, _args.n_robots, _device)
