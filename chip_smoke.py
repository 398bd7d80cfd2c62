#!/usr/bin/env python3
"""Drive the PyTorch port of the DWA control tick, of the device fleet
tick and its k-tick loop, of the local occupancy mapper, of the global
planners, of the serving artifacts, of the scale-out over a device mesh,
of the benchmark runner, of the benchmark tools and of the README's nine
workflows (``examples_torch/``) once on an NVIDIA GPU, then the JAX
package's own main-path tests on the card (the card twins).

Run from the repository root, with no arguments, on a machine with one
CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases (each one asserts; any failure exits non-zero with its traceback):

1. Environment: the card's name and power limit, torch and nvcc versions.
2. Build: compiles the kernels of ``kompass_core_tpu_torch/csrc/`` with
   nvcc for sm_90a into ``build/kompass_core_tpu_torch/`` and prints the
   build time, the compiler's register report and each kernel's SASS
   instruction count (the sweeps' hottest loop per (point, row) pair);
   builds and loads the port's native host library with g++ (fails if it
   does not load).
3. Kernels vs plain versions on the card, bit-identical outputs
   (``torch.equal``): the static sweep (K1's port) at the flagship and
   edge shapes, and on its edge cases (NaN and +-inf points and rows,
   pad rows, a point on a row, values above 1e18, three segment rows,
   the evaluator's rows, rows past one tile, samples past one block,
   T = 1, 64 robots with mixed active steps) at its own samples per
   thread and at each one the static kernel takes; the batched static sweep
   against per-robot launches; the
   moving sweep (K3's port) at the flagship and fleet shapes, with pad
   rows, ragged tiles, rows past one tile, samples past one block, T = 1,
   a ragged block and NaN / +-inf points and rows (NaN where the plain
   version has it), and at zero velocity against K1 at the flagship and
   fleet shapes.
4. The single-robot slice end to end: the flagship DWA (2025 samples x
   30 steps, 512-ray scan, 384 segment slots) through ``DWA.loop_step``
   on ``cuda`` for 60 closed-loop ticks in drop mode and 10 in truncate
   mode; every tick launches K1 exactly once and agrees with the same
   packed input solved by the port on the CPU.
5. The fleet slice end to end: ``DeviceFleet`` on ``cuda`` with 64
   diff-drive robots on their own corridors, the same solve shapes, 512
   rays and 8 tracked slots with one live mover per robot crossing its
   path, for 30 closed-loop ticks. Every tick launches the moving sweep
   exactly once, makes no host sync between its input copy and its
   output copy, and on 4 ticks the rows of 4 sampled robots agree with
   the port's CPU tick on those robots' inputs and carry.
6. The mapper's per-cell kernel (K5's port) against its plain version on
   the card, bit for bit, plain and Bayesian: 400 x 400 / 3600 with 0,
   NaN and +inf beams; a ragged 333 x 517 / 1000 grid with an offset,
   rotated laser; a batch of 64 robots against 64 one-robot launches;
   both grids with tables whose every beam ends on a cell that lies on
   its line test's bound; in each case the beam pass (the call's first
   launch) against ``line_test_bounds``, and once more with endpoints
   across the 15-bit clip range.
7. The mapping slice end to end: a Bayesian 400 x 400 ``LocalMapper`` on
   ``cuda`` walking the S-curve for 30 updates from 3600-ray scans of the
   posts and corridor walls, one 100k-point cloud update, and one call of
   each 64-robot fleet mapper. Every update launches K5 exactly once; on
   4 updates, the cloud update and 4 fleet robots the port's CPU run of
   the same inputs gives the same layers, except cells that a beam whose
   table differs between the devices explains (their count is printed).
8. The expanded sweeps against their plain versions on the card, bit for
   bit: K2's port (both sweeps) and K4's port (one sweep, launched over
   the obstacle rows and over the segment rows) at the flagship shapes,
   with pad rows, ragged tiles and a ragged block, and a batch of 64
   robots against 64 one-robot launches; K2 and K4 on phase 3's edge
   cases at each number of samples per thread.
9. The scenario-batched solver slice end to end: ``make_fleet_solver`` on
   ``cuda`` with 64 BASELINE scenarios (``bench.py``'s production serving
   mode), backends ``xla``, ``pallas`` and ``pallas_v1``, 3 distinct
   batches each. Every call launches exactly its backend's kernels (K1
   once, K2 once, K4 twice); 4 rows of each backend's first batch agree
   with the port's CPU solve of the same buffers; one 130-row call in
   chunks of 64 agrees with one dispatch.
10. The standalone cost evaluator at ``CostEvaluator_5k_Trajs``'s size
    (5001 given trajectories x 1000 points, 1024 segment slots, no
    obstacles): one K1 launch; 64 rows' costs agree with the CPU.
11. A BOX robot's flagship DWA with a custom cost on ``cuda`` for 5
    closed-loop ticks in lockstep with the same controller on the CPU,
    then one ``debug_velocity_search`` on both.
12. Times: the single-robot tick latency over 220 ticks; K1 at its three
    path shapes (the flagship in drop and truncate mode, 64 robots, the
    cost evaluator), K2 and K4 at theirs (the flagship, 64 robots) and K6
    at the flagship and the k-tick loop's 64 robots (768 + 384 rows), each
    against its plain version in turns (CUDA events, back to back, the
    kernels line's times) and by the replay of a CUDA graph of its
    launches (printed beside them), with its samples per thread; the
    tracked and the static 64-robot fleet tick over 30 ticks each (host
    clock and CUDA events); K3 and its plain version at the fleet shapes
    over 10 distinct inputs, in turns; ``update_from_scan`` over 100
    updates, Bayesian and plain, and its host parts; K5 and its plain
    version at one and at 64 robots over 10 distinct inputs, in turns;
    the 64-robot Bayesian fleet mapper per call; the 64-scenario fleet
    solver per call and in solves/s for each backend; the cost evaluator
    per call. Each kernel's time is printed
    beside its bound (the larger of its FP32 operations at 33.5 T
    single-rounded operations/s and its bytes at 3.35 TB/s) and its
    share of it.

13. The TPU kernels' own forms against their plain versions on the card,
    bit for bit: K6 (``_fused_kernel_vpu``'s broadcast form), K7 and K8
    (the 7-feature forms of ``_fused_kernel_mxu_moving`` and
    ``_fused_kernel_vpu_moving``) at the k-tick loop's shapes (64 robots
    x 2025 x 30 vs 768 + 384 rows) and the moving sweep's edge cases;
    K8 at zero velocity against K6, K7 against K2 within rel 2e-4 / atol
    1e-4, and their segment fields against K2's and K6's; K6 on phase 3's
    edge cases at each number of samples per thread.
14. The k-tick loop end to end: the 64-robot fleet, k = 8, through
    ``DeviceFleet.run_ticks_on_device`` (one CUDA graph per k) with
    backends ``xla`` (K3), ``pallas`` (K7) and ``pallas_vpu`` (K8) and 8
    tracked slots, and ``pallas_vpu`` without (K6), 3 closed-loop calls
    each: every replay equals the eager loop on the card bit for bit and
    launches its kernel k times; then 4 robots' loop on the card against
    the CPU.
15. Times: K6, K7 and K8 against their plain versions at the fleet
    shapes, in turns, beside their bounds; the k-tick loop per tick,
    replayed and eager (host clock with syncs), and the replay alone
    (CUDA events).
16. The emergency checker: ``EmergencyChecker`` on the card against the
    CPU, bit for bit, on 512-ray scans (NaN and inf returns, beams at
    the critical and at the slowdown distance) and 100k-point clouds,
    with a centered sensor, a translated and rotated one and the
    360-degree cone, both directions (a cloud factor that differs must
    come from a point binned across a bin edge).
17. Peers, prediction and safety at full width: 64 robots in head-on and
    crossing pairs and driven at walls (``PeerDrive``), peers with 8
    ring points, prediction, 8 tracked slots and the safety gate at
    ``FleetSafetyConfig()``'s defaults, 30 closed-loop single ticks per
    backend (``xla``: K3, ``pallas``: K7, ``pallas_vpu``: K8), each
    sweep against 1344 + 384 rows: one launch per tick, no host sync, 4
    robots on 2 ticks against the CPU, the wall robots slowed, the boxed
    robot stopped with a zero command every tick, no two robots closer
    than the sum of their radii; then peers without prediction or
    tracked slots launch K1.
18. The k = 8 loop with peers, prediction and safety per backend: replay
    == eager bit for bit, 3 calls; the wall robots slowed and then
    stopped inside the loop; no collision.
19. K1, K3, K6, K7 and K8 against their plain versions at the peer width
    (64 x 2025 x 30 vs 1344 + 384 rows, each robot's own peer block at
    the pad), bit for bit.
20. Times: those sweeps against their plain versions at the peer width,
    in turns, beside their bounds; the peer fleet's tick (median and
    p99 of 30) and its k = 8 graph per tick, beside the same run's
    no-peer fleet.
21. K9 (``box_min_dist_sq``, the oriented-box field of BOX robots,
    ``csrc/box_min_dist.cu``) and K3s (``min_dist_sq_moving``, K3's
    obstacle sweep alone, for the split movers) against their plain
    versions, bit for bit: K9 static and moving at 64 x 2025 x 30 vs
    768 rows (per-robot extents with (0, 0) circles, pad rows, a point
    inside a footprint, NaN, inf and values above 1e18, mixed active
    steps), at one robot (2025 x 30 vs 512) and on ragged tiles, at each
    number of samples per thread; K3s at the fleet shape against 8 rows,
    ``POINT_MAJOR_ROWS`` (M*), M* + 1 and 1100 rows (pads, a NaN row, an
    inf point, a row whose move overflows, mixed active steps), in its
    own layout (point-major up to M* rows) and forced into each, and
    against K3's obstacle field. Then K9's heading probe (ROADMAP fault
    2, ``heading_probe``): the collision decisions of 2 x 16384 points on
    the margin's contour with the card's cos, sin and K9 against the
    CPU's, counted and printed.
22. The split tracked fleet (``split_mover_sweep``): 64 robots, 30
    closed-loop ticks, K1 and K3s once per tick, no host sync, equal to
    the tail-slot fleet on the card bit for bit every tick, 4 robots on 2
    ticks against the CPU; its k = 8 graph (replay == eager); then 5
    ticks with M* + 1 tracked slots (K3s in K3's layout), equal to their
    tail-slot fleet.
23. The mixed circle + BOX fleet (every fourth robot a BOX) with peers,
    prediction, tracked slots and the safety gate: 30 ticks, K3 and K9
    once per tick, 4 robots on 2 ticks against the CPU, no contact; its
    k = 8 graph. Phase 11's BOX DWA launches K9 once per tick.
24. The controller registry: every ``ControlClasses`` entry built and
    stepped 5 times (DWA on the card, the host controllers and the
    vision followers on the host).
25. Times: the split against the tail-slot fleet and the BOX against
    the circle peer fleet (tick median, k = 8 graph per tick and its
    replay alone by CUDA events, in turns), K9 against its plain version
    at 64 x 2025 x 30 vs 768 static rows and 1344 moving rows, K3s at 8
    rows against its plain version, and K3s in each layout by graph
    replay and by events at 8, 16, 32, 64, 128 and 256 rows, in turns,
    beside their bounds.
26. One ``torch.profiler`` pass over one k = 8 replay of the tail-slot
    and of the split tracked fleet: the ten kernels with the most device
    time (fails if the profiler records none).
27. Global planning on the turtlebot problem (the reference's own,
    ``tests/resources/reference/ompl``, at ``planner_bench.py``'s
    settings): every one of the 30 registry ids solves on the card with
    its scans replayed as CUDA graphs, the three timed ids of phase 29
    twice; each path starts at the start, ends within ``goal_tolerance``
    of the goal and is free by the host check; its length beside the
    reference's, and the first (capture included) and second solve's
    seconds.
28. The twelve planning device programs (the roadmap solve, RRT*, RRT#,
    RRT-Connect, EST, KPIECE1, SST, FMT*, TRRT, BiEST, PDST, BFMT*) at the
    bench shape on the card and on the CPU on the same draws, made once
    on the CPU: discrete outputs equal, nodes and costs within rel 1e-4.
29. Each of the 11 planning scan cores replayed as CUDA graphs equals its
    eager loop on the card bit for bit (3 chunks and a remainder, two
    calls); eager and replay per iteration for RRT*, RRT-Connect and EST.
30. The fleet planner: ``solve_fleet`` for 16 robots on the turtlebot
    map, every robot solved with a valid path, and the one-dispatch
    roadmap solve timed. Planning reaches no kernel of the kernels line.
31. Serving, the flagship packed solver (``serving/export.py``): the
    solver of phase 4's spec exported on the card with ``torch.export``
    (its graph holds K1's operator, ``kompass_torch::fused_min_dist_sq``,
    once), then loaded in this process, in a fresh process that imports
    only ``kompass_core_tpu_torch.serving`` (and asserts that no ``ops``
    or ``control`` module came with it), and exported on the CPU and
    loaded on the card; each serves the first 10 packed inputs of phase
    4's closed loop: every output equals the live solver's with
    ``torch.equal``, every served call launches K1 exactly once.
32. Serving the 64-robot fleet with 8 tracked slots: a tick artifact and
    a k = 8 artifact (the eager k-tick loop) per backend (``xla``: K3,
    ``pallas``: K7, ``pallas_vpu``: K8) and the static ``pallas_vpu``
    fleet's tick artifact (K6), each exported on the CPU for both device
    types by a process of its own, all at once (``export_fleet_artifacts``:
    the tracing is host work), then loaded on the card and called 5
    times in a chained closed loop beside the live ``DeviceFleet.tick`` or
    ``run_ticks_on_device`` on the same inputs: outputs, final states and
    carry bit for bit, the backend's kernel once per served tick.
33. A snapshot of the tracked fleet after 4 ticks (``state_dict``, through
    a disk round trip) restored into a new fleet on the card: 3 more ticks
    equal the original's bit for bit; then a 32-robot tick artifact
    (exported with phase 32's) served over ``[cuda, cuda]`` by
    ``sharded_fleet_call`` equals the 64-robot tick bit for bit.
34. Serving times: per artifact the export seconds (in its own process
    for the fleet's, beside the wall time of all of them), its bytes, the
    cold load (load and first call) and the served against the live program
    per call in turns (CUDA events, median of 5, for the solver; the
    host clock with syncs, median of 5, for the fleet; for the k = 8
    artifacts also the live graph replay), and the flagship
    ``DWA.loop_step`` median of phase 12 with the kernels as operators.
35. Scale-out, the fleet on a mesh (``parallel/multihost.py``): the
    128-robot peer fleet (phase 17's scene widened, peers, prediction, 8
    tracked slots, the safety gate) on a 2-shard mesh ``[cuda, cuda]``
    beside the same fleet on ``cuda``, per backend (K3, K7, K8): 10 ticks
    and 2 calls of ``run_ticks_on_device(8)`` (eager on the mesh, the
    graph on one device), every output bit for bit; each shard launches
    once per tick, and the mesh gathers the states once per tick (8 per
    call); then one tick each without prediction (K1, one gather), with
    tracked slots and no peers (K3) and static on ``pallas_vpu`` (K6),
    the last two with no collective.
36. The sharded solver: ``make_fleet_solver`` on 128 BASELINE scenarios
    over 2 shards per backend (K1, K2 or K4 per shard) == one device bit
    for bit with no collective; a 129-robot ``FleetPlanner`` (130 rows,
    one pad row not found); ``make_sample_parallel_solver`` on the
    flagship over 4 shards (K1 once a shard, three all-reduces) == the
    one-device full-window solve, and against the CPU port's.
37. Two processes on the card in a gloo group (``mesh_worker``), each a
    one-shard mesh: half the 128 scenarios and 5 ticks of the 128-robot
    peer fleet each, == this process's one-device results bit for bit.
38. ``FleetRuntime`` (32 Ackermann robots over ``[cuda, cuda]``): every
    robot reaches its goal with ``solver_failures == 0``.
39. Mesh times: the mesh tick against the one-device tick, the eager mesh
    k = 8 call against the one-device replay per tick, one gather and
    its share, the two-process wall seconds, FleetRuntime's host ms.
40. The reference's recordings (``tests/resources/reference``), as the
    JAX package's own tests assert them: the Ackermann DWA of
    ``test_reference_fixtures.py`` follows the recorded global plan to
    its end on the card (K1 once per solve, each solve equal to the
    CPU's), and the recorded 360-ray scan, the recorded Livox frame and
    an empty cloud each go through ``LocalMapper`` on the card (K5 once
    each, every layer equal to the CPU mapper's; the walls stamp
    occupied cells, the empty cloud none).
41. The benchmark layer (``kompass_core_tpu_torch/benchmark/``):
    ``BenchmarkRunner(cuda).run_all()`` once, its nine workloads at the
    reference's sizes (DWA_2025x30, DWA_LargeBatch_65k at 255 x 255
    samples, DWA_Fleet_64, CostEvaluator_5k_Trajs, the three 400 x 400
    mappers, the two critical-zone checks), each record logged beside the
    card's name and power limit with a finite, positive p50, each DWA
    workload and the evaluator launching K1 and each mapper K5 exactly once
    per dispatch (46 each); the DWA device loop at K = 4 and 12 (one CUDA
    graph per K); then one DWA_2025x30 variant against the CPU port, K1's
    call of one DWA_LargeBatch_65k solve against its plain version bit
    for bit, and the device loop's replayed final cost equal to the same
    chain run eagerly on the card.
42. The benchmark tools (``benchmark/scaling_proof.py``,
    ``batch_cliff.py``, ``chunk_unroll_bench.py``, ``mapper_split.py``):
    the seven mesh programs' collectives over ``[cuda, cuda]`` (none for
    the packed solver and the plain, safety, tracked and split ticks, one
    all-gather for the peer tick, three all-reduces for the
    sample-parallel solve); the flagship's batched device loop at 64 and
    80 rows, K = 4 and 12 (µs per solve); the 1024-robot fleet's tick
    captured with its robot axis whole and in 64-row blocks, 3 replays
    each: blocked == whole bit for bit, rows 0, 511 and 1023 against a
    3-robot fleet of those robots on the CPU, the peak memory; the mapper
    split (beam side, K5's cell pass, the whole update, by slope and by
    device loop) and its shoot-out (the update through K5 == through its
    plain version).
43. The README's nine workflows (``examples_torch/``), each
    ``run(cuda, ...)`` at its README size with the JAX demo's own
    assertions: the full stack on the CPU's PRM plan (every DWA solve
    against the CPU's solve of the same input, then the outcome lines
    equal to the port's CPU run), the dynamic world likewise,
    ``fleet_demo`` at 100 robots in lanes and at 8 in the host, peer,
    prediction and mesh modes (the 8-robot lines equal to the CPU's), the
    RTT serving at k = 1 and 8 and the AOT artifact (lines equal to the
    CPU's), the serving restart and the sharded artifact (bit-identical
    on the card), the vision and offline host workflows (no launch); then
    ``python examples_torch/full_stack_demo.py`` in a subprocess with no
    arguments (it plans and runs on the card by default). Each workflow's
    wall time and launches by kernel are printed.
44. The card twins (``phase_card_twins``): the JAX package's own tests
    run against the port on the card, ``tests/test_torch_twin_cuda.py``
    and ``tests/test_torch_twin_cuda_main.py`` (the tick, the closed loop,
    moving obstacles, the fleet and its k-tick graph, safety, scale-out
    on ``[cuda] * 8``, the mapper, planning, serving and the benchmark
    runner), in this process through ``pytest.main`` with ``--noconftest
    -m cuda``, but the turtlebot map's 28 planner solves (phase 27 solves
    each id) and the serving file, over the budget (phases 31-34 serve on
    the card). Fails on a pytest exit other than 0, on any failed or
    skipped test, on a kernel of ``CARD_TWIN_KERNELS`` that did not
    launch, or past ``CARD_TWIN_BUDGET_S``; prints the passes and seconds
    per twinned file.
45. K10, the goal cost's nearest-segment search (``phase_goal``, run
    after phase 25): ``goal_nearest`` bit for bit against its plain
    version, in its own layout and in each of ``GOAL_LAYOUTS``, at the
    benchmark cells' widths (1024 x 2025 x 320, 256 x 2025 x 320, 64 x
    2025 x 384), one robot's DWA (1 x 2025 x 320) and the cost
    evaluator's (1 x 5001 x 1024), where a warp splits the segment
    points; timed against it by events in turns and by graph replay
    beside ``goal_bound``, and each layout by replay
    (``kernel_bench.bench_goal``); the kernels line's K10 row times the
    1024-robot width and gives the largest |kernel - plain| of every
    width. Every solve on the card launches K10 once, so each phase's
    launch check counts it beside the sweeps (``_solves``); the row's
    launches are the main path's, read as every other row's are, plus
    the card solves of phases 4, 5, 9, 10 and 11 and the k-tick forms'.

Launch counts: the counts are set to 0 before the mapping slice, again
before the solver slice, again before the k-tick loop and again before
the peer path (phases 17 and 18, read after them); the kernels line
reports K1 and K3 from phases 4 and 5, K5 from phase 7, K2 and K4 from
phase 9 and K6, K7 and K8 from phase 14, counted around the
``run_ticks_on_device`` calls alone (the warm-up's and each replay's
launches: a replay calls no wrapper, so each replay counts the captured
loop's launches once), and adds the peer path's K1, K3, K7 and K8
launches (phase 18 counted as phase 14 is); the counts are set to 0
again before phases 22 and 23, whose launches (around their own fleets'
calls, not the comparisons') give K3s (both layouts) and add to K1, K3
and K9 (with phase 11's K9 launches). Its times are
K1, K2 and K4 at the flagship shapes (one robot), K3, K5, K6, K7 and K8
at 64 robots, all by CUDA events in turns with the plain version. K1,
K2, K4 and K6 are one static kernel (``static_min_dist_kernel``); its
samples per thread come from ``ops/kernels.py::sweep_points``. The counts
are set to 0 again before the mesh phases (35-38): each kernel's row adds
the launches of the mesh calls alone (not the one-device fleets and
solves they are compared with) and those the two worker processes report.
The counts are set to 0 again before phase 40, whose K1 and K5 launches
add to their rows, and again before phase 41, whose runner dispatches
and device loop (its warm-ups and replays) add theirs, and again before
phase 42, whose launches add to K1, K3, K3s and K5: the mesh programs'
wrapper calls, and for each captured loop or tick the warm-up's and each
replay's (a replay calls no wrapper; its launches are the captured ones),
and again before phase 43, whose card runs' launches add to K1, K3 and
K5 (the RTT workflow's k-tick loop counted as phase 42's loops are; the
CPU runs it is compared with launch nothing), and again before phase 44,
whose wrapper calls add to every kernel the twins reach (a captured
graph's replays launch without a wrapper and are not counted there).
The script prints its seconds so far after each phase.

Before the last line it prints the card's name and power limit and one
JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# the benchmark layer's scenario builder, bounds (the card's peaks: the
# NVIDIA H100 SXM data sheet's, at 700 W), event timers and planner problem
from kompass_core_tpu_torch.benchmark.baseline import build_scenario as baseline_scenario
from kompass_core_tpu_torch.benchmark.kernel_bench import _events_ms, _graph_ms, _in_turns
from kompass_core_tpu_torch.benchmark.planner_bench import CONFIG as PLAN_CONFIG
from kompass_core_tpu_torch.benchmark.planner_bench import GOAL as PLAN_GOAL
from kompass_core_tpu_torch.benchmark.planner_bench import ROBOT as PLAN_ROBOT
from kompass_core_tpu_torch.benchmark.planner_bench import START as PLAN_START
from kompass_core_tpu_torch.benchmark.planner_bench import problem as plan_problem
from kompass_core_tpu_torch.benchmark.roofline import (
    bound,
    cells_bound,
    form_bound,
    sweep_bound,
)
from kompass_core_tpu_torch.benchmark.runner import evaluator_inputs, slope_variants_needed

# flagship configuration: 45 x 45 samples, 30-step horizon, 512-ray scan;
# vx_max 1.2 m/s sizes the tracked segment at 384 slots
SAMPLES = 45
HORIZON = 30
CONTROL_HORIZON = 6
DT = 0.1
RAYS = 512
VX_MAX = 1.2
RANGE_MAX = 10.0
# (samples, steps, obstacle slots, segment slots) every slice tick solves
SLICE_SHAPE = (2025, 30, 512, 384)

SLICE_TICKS = 60
TRUNCATE_TICKS = 10
TIMED_TICKS = 220
TIMED_WARMUP = 10
KERNEL_INPUTS = 100

COST_REL = 1e-4  # CPU vs card, per tick (the port's solver parity tolerance)
TIE_REL = 1e-6  # two winners within this are a tie of sin/cos ulps

# the fleet slice: 64 robots at the solve shapes above, 8 tracked slots
# (the scan bucket holds 512 rays + 8 slots, rounded to 768)
FLEET_ROBOTS = 64
FLEET_TRACKED = 8
FLEET_SHAPE = (FLEET_ROBOTS, 2025, 30, 768, 384)
FLEET_TICKS = 30
FLEET_CPU_TICKS = (0, 10, 20, 29)
FLEET_CPU_ROBOTS = (0, 21, 42, 63)
FLEET_TIMED_TICKS = 30  # ticks per fleet timer
FLEET_KERNEL_INPUTS = 10
LANE_SPACING = 10.0

KERNEL_SOURCE = "kompass_core_tpu_torch/csrc/fused_min_dist.cu"
# K1 and K3 compute the JAX package's XLA sweeps (backend "xla"); the
# others are the TPU kernels of ops/pallas_kernels.py
KERNEL_REPLACES = "kompass_core_tpu/ops/solver.py:347"
MOVING_REPLACES = "kompass_core_tpu/ops/solver.py:365"
EXPANDED_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:56"
SINGLE_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:387"
BROADCAST_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:89"
MOVING_EXPANDED_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:116"
MOVING_BROADCAST_REPLACES = "kompass_core_tpu/ops/pallas_kernels.py:171"

# the TPU kernels' own forms: (PERF.md name, wrapper, moving)
TPU_FORMS = (("K6", "fused_min_dist_sq_broadcast", False),
             ("K7", "fused_min_dist_sq_moving_expanded", True),
             ("K8", "fused_min_dist_sq_moving_broadcast", True))
TPU_FORM_INPUTS = 4  # distinct inputs per timed run (K7's plain version
# takes about a second at the fleet shapes: its FMAs go through float64)
# the k-tick loop: k ticks per call on the fleet slice's fleet; per
# (backend, tracked slots) the kernel each tick launches once
TICKS_K = 8
TICKS_FORMS = (("xla", FLEET_TRACKED, "K3"), ("pallas", FLEET_TRACKED, "K7"),
               ("pallas_vpu", FLEET_TRACKED, "K8"), ("pallas_vpu", 0, "K6"))
TICKS_CALLS = 3  # graph replays per form in the main-path run
TICKS_TIMED = 10  # calls per timer
TICKS_CPU_ROBOTS = 4

# the scenario-batched solver slice: bench.py's production serving mode
# (config v1_batch64), 64 BASELINE scenarios per call
SOLVER_ROBOTS = 64
SOLVER_BACKENDS = ("xla", "pallas", "pallas_v1")
SOLVER_BATCHES = 3
SOLVER_CPU_ROWS = (0, 21, 42, 63)
SOLVER_CHUNK = 64  # make_fleet_solver's default chunk_size
SOLVER_RAGGED = 130  # rows of the chunked call: 3 chunks, the tail padded
SOLVER_TIMED = 20
# CostEvaluator_5k_Trajs (kompass_core_tpu/benchmark/runner.py:207-308):
# given trajectories x points, segment slots
EVAL_SHAPE = (5001, 1000, 1024)
EVAL_CPU_ROWS = 64
EVAL_TIMED = 10
BOX_TICKS = 5
BOX_PARAMS = (0.5, 0.4, 0.4)  # length, width, height: half extents 0.25 x 0.2
BOX_COST_WEIGHT = 0.5


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# --- the scene --------------------------------------------------------------


def reference_path():
    """A 40 m S-curve through a corridor, starting at the robot."""
    y = np.linspace(0.0, 40.0, 161)
    return np.stack([2.0 * np.sin(y / 3.0), y], axis=1)


def obstacle_circles():
    """(cx, cy, r): posts beside the path on alternating sides."""
    ys = np.arange(3.0, 40.0, 3.0)
    side = np.where(np.arange(len(ys)) % 2 == 0, 1.0, -1.0)
    return np.stack([2.0 * np.sin(ys / 3.0) + 1.3 * side, ys,
                     np.full(len(ys), 0.3)], axis=1)


CORRIDOR_X = 5.0


def cast_scan(state, circles, rays=RAYS):
    """A scan of ``rays`` rays (512 by default) from the robot's pose
    against the posts and the corridor walls (x = +-5); no hit within
    range gives +inf."""
    from kompass_core_tpu_torch.datatypes import LaserScanData

    angles = np.linspace(-np.pi, np.pi, rays, endpoint=False)
    th = state.yaw + angles
    dx, dy = np.cos(th), np.sin(th)
    best = np.full(rays, np.inf)
    for cx, cy, r in circles:
        ox, oy = cx - state.x, cy - state.y
        b = dx * ox + dy * oy
        disc = b * b - (ox * ox + oy * oy - r * r)
        t = b - np.sqrt(np.maximum(disc, 0.0))
        best = np.where((disc >= 0.0) & (t > 0.0) & (t < best), t, best)
    with np.errstate(divide="ignore", invalid="ignore"):
        for wall in (-CORRIDOR_X, CORRIDOR_X):
            t = (wall - state.x) / dx
            best = np.where((t > 0.0) & (t < best), t, best)
    ranges = np.where(best <= RANGE_MAX, best, np.inf)
    return LaserScanData(ranges=ranges, angles=angles, range_max=RANGE_MAX)


def make_robot(box=False):
    from kompass_core_tpu_torch.models import Robot, RobotGeometry, RobotType

    robot = Robot(
        robot_type=RobotType.DIFFERENTIAL_DRIVE,
        geometry_type=RobotGeometry.Type.BOX if box else RobotGeometry.Type.CYLINDER,
        geometry_params=np.array(BOX_PARAMS if box else [0.25, 0.4]),
    )
    robot.state.x, robot.state.y, robot.state.yaw = 0.0, 0.0, math.pi / 2
    return robot


def make_dwa(robot, device, drop_samples=True):
    from kompass_core_tpu_torch.control import DWA, DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, RobotCtrlLimits,
    )

    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=VX_MAX, max_acc=1.5, max_decel=2.5),
        omega_limits=AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0),
    )
    config = DWAConfig(
        max_linear_samples=SAMPLES, max_angular_samples=SAMPLES,
        prediction_horizon=HORIZON, control_horizon=CONTROL_HORIZON,
        control_time_step=DT, drop_samples=drop_samples,
    )
    dwa = DWA(robot=robot, ctrl_limits=limits, config=config, device=device)
    dwa.set_path(reference_path())
    return dwa


def apply_first_command(robot, dwa):
    """Integrate the first commanded velocity for one control step (a
    10 Hz controller applies the newest command every tick)."""
    robot.set_control(
        velocity_x=float(dwa.linear_x_control[0]),
        velocity_y=float(dwa.linear_y_control[0]),
        omega=float(dwa.angular_control[0]),
    )
    robot.get_state(dt=DT)


def goal_distance(robot):
    gx, gy = reference_path()[-1]
    return math.hypot(robot.state.x - gx, robot.state.y - gy)


# --- phases -------------------------------------------------------------------


def phase_environment(kernels):
    import torch

    log("card:", card_line())
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    nvcc = kernels._nvcc()
    log(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                       check=True, timeout=60).stdout.strip().splitlines()[-1])


def phase_build(kernels):
    from kompass_core_tpu_torch import native

    fresh = not kernels.library_path().exists()
    t0 = time.perf_counter()
    lib = kernels.build_library()
    log(f"build: {'compiled' if fresh else 'found'} {lib} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log("ptxas:", line.strip())
    sass_report(kernels, lib)
    t0 = time.perf_counter()
    loaded = native.native_available()
    log(f"native host library: {'loaded' if loaded else 'NOT loaded'} "
        f"{native.library_path()} in {time.perf_counter() - t0:.2f} s")
    assert loaded, "the port's native host library did not build or load"


_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def sass_loops(text):
    """(the opcodes of one function's SASS, [the opcodes of each loop
    body]): a loop is a branch back to a label or an address above it."""
    ops, where, loops = [], {}, []
    for line in text.splitlines():
        label = _SASS_LABEL.match(line)
        if label:
            where[label.group(1)] = len(ops)
            continue
        m = _SASS_LINE.search(line)
        if not m:
            continue
        where[f"0x{int(m.group(1), 16):x}"] = len(ops)
        ops.append(m.group(2).split(".")[0])
        target = _SASS_TARGET.search(m.group(3))
        if ops[-1] == "BRA" and target:
            key = target.group(1) or f"0x{int(target.group(2), 16):x}"
            if key in where and where[key] < len(ops) - 1:
                loops.append(ops[where[key]:])
    return ops, loops


def sass_report(kernels, lib):
    """Each kernel's SASS instruction count (cuobjdump -sass, kept beside
    the library as sass.txt), and for the sweeps their hottest loop (the
    loop densest in (point, row) pairs, each ending in one min: the
    unrolled row loop; in the kernels with an fminf form, that form's
    loop) and its instructions per pair."""
    from collections import Counter
    from pathlib import Path

    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        log(f"sass: {cuobjdump} not found, no instruction counts")
        return
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    (lib.parent / "sass.txt").write_text(out)
    funcs = [func.split("\n", 1) for func in re.split(r"\n\s*Function : ", out)[1:]]
    names = [name.strip() for name, _ in funcs]
    filt = cuobjdump.with_name("cu++filt")
    if filt.exists():  # the template arguments, readable
        names = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                               text=True, check=True, timeout=60).stdout.splitlines()
    for name, (_, body) in zip(names, funcs):
        name = name[:name.rfind("(")] if name.endswith(")") else name  # no parameters
        ops, loops = sass_loops(body)
        line = f"sass: {name}: {len(ops)} instructions"
        loops = [Counter(loop) for loop in loops]
        if "min_dist_kernel" in name and loops:
            # a pair ends in one min: FMNMX (fminf) or FSEL (the NaN-keeping
            # min); the loop densest in them is the innermost row loop. K9's
            # fminf pair also clamps twice with FMNMX: three per pair
            per = 3 if "box_min_dist_kernel" in name else 1

            def pairs_of(c):
                return (c["FMNMX"] or c["FSEL"]) / per

            hot = max(loops, key=lambda c: (pairs_of(c) / sum(c.values()), pairs_of(c)))
            pairs = max(pairs_of(hot), 1)
            mix = ", ".join(f"{k} {v}" for k, v in hot.most_common(8))
            line += (f"; hottest loop {sum(hot.values())} instructions for "
                     f"{pairs:g} pairs = {sum(hot.values()) / pairs:.2f} per pair "
                     f"({mix})")
        else:
            mix = ", ".join(f"{k} {v}" for k, v in Counter(ops).most_common(12))
            line += f" ({mix})"
        log(line)


def _sweep_case(gen, device, S, T, O, G, span=10.0):
    import torch

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * span).to(device)

    return u(S, T), u(S, T), u(O, 2).contiguous(), u(G), u(G)


def phase_kernel_vs_plain(kernels, device):
    """K1 and its plain version on the same card tensors must be equal:
    _static_cases at each number of samples per thread."""
    return _static_vs_plain(kernels, "fused_min_dist_sq", device, 10)


def _static_cases(gen, device):
    """The static kernel's edge cases (K1, K2, K4, K6), each a
    _moving_case (its velocities and steps unused) and its active steps
    (None: random per robot). Robot 0 of the NaN case has NaN and +-inf
    points and rows, robot 1 none (the fminf path), robot 2 one NaN
    obstacle row. In the case of values above 1e18, robot 0's point
    (1.2e19, 1.2e19) against its row (1.5e19, -1.5e19) is NaN in the
    broadcast form alone (inf - inf from finite values)."""
    import torch

    S, T, O, G = SLICE_SHAPE
    cases = [(f"flagship active={a}", _moving_case(gen, device, 1, S, T, O, G), a)
             for a in (T, 17)]
    case = _moving_case(gen, device, 1, S, T, O, G)
    case[2][:, O - 112:] = 1e8
    case[5][:, G - 83:], case[6][:, G - 83:] = 1e8, 1e8
    cases.append(("pad rows at 1e8 (112 obstacle, 83 segment)", case, T))
    case = _moving_case(gen, device, 1, S, T, O, G)
    case[2][:] = 1e8
    cases.append(("all obstacle rows at the 1e8 pad", case, T))
    cases.append(("O=4096", _moving_case(gen, device, 1, S, T, 4096, G), T))
    cases.append(("O=700, G=333 (ragged tiles)",
                  _moving_case(gen, device, 1, S, T, 700, 333), T))
    cases.append(("S*T=259 (ragged block)", _moving_case(gen, device, 1, 37, 7, O, G), 5))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 2, 300, T, O, G)
    obs[0, 7] = torch.stack([px[0, 3, 5], py[0, 3, 5]])
    sx[1, 11], sy[1, 11] = px[1, 9, 2], py[1, 9, 2]
    cases.append(("a point on an obstacle row and on a segment row (d2 = +0)",
                  (px, py, obs, vel, dt, sx, sy), T))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 3, 300, T, 1100, G)
    cases.append(("NaN and +-inf points and rows, rows past one tile",
                  (*_non_finite(px, py, obs, vel, sx, sy)[:4], dt, sx, sy), T))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 2, 300, T, O, G)
    px[0, 5, 3], py[0, 9, 9], obs[0, 4, 0], sy[0, 6] = 3e18, -2e19, 5e18, -7e18
    px[0, 7, 2], py[0, 7, 2] = 1.2e19, 1.2e19
    obs[0, 9] = torch.tensor([1.5e19, -1.5e19])
    obs[1, 400:] = 2e19
    cases.append(("values above 1e18 (robot 0 scattered, robot 1 obstacle rows)",
                  (px, py, obs, vel, dt, sx, sy), T))
    cases.append(("O=1, G=3 (one obstacle row, three segment rows)",
                  _moving_case(gen, device, 1, S, T, 1, 3), T))
    cases.append(("O=1, G=1024 (the cost evaluator's rows)",
                  _moving_case(gen, device, 1, 1000, 40, 1, 1024), 40))
    cases.append(("O=1100, G=1025 (rows past one tile)",
                  _moving_case(gen, device, 1, S, T, 1100, 1025), 17))
    cases.append(("S=1025, T=7 (samples past one block)",
                  _moving_case(gen, device, 2, 1025, 7, O, G), 5))
    cases.append(("T=1, B=3", _moving_case(gen, device, 3, S, 1, O, G), 1))
    cases.append((f"B={SOLVER_ROBOTS}, mixed active steps",
                  _moving_case(gen, device, SOLVER_ROBOTS, S, T, O, G), None))
    return cases


def _check_nan_equal(name, got, want):
    """Each output pair equal bit for bit, NaN where the other has NaN;
    returns the max abs difference of the non-NaN values (0 where both
    are inf)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan()), f"{name}: NaN differs"
        g, w = (torch.where(v.isnan(), 0.0, v) for v in (g, w))
        both_inf = torch.isinf(g) & torch.isinf(w)
        err = max(err, float(torch.where(both_inf, 0.0, (g - w).abs()).max()))
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (
            f"{name}: kernel != plain (max abs {err})")
    return err


def _static_fields(kernels, wrapper, plain=False):
    """A static sweep's wrapper (or its plain version) with the fused
    sweeps' arguments (px, py, obs, sx, sy, ap), returning its fields as a
    tuple: K4 (``min_dist_sq_expanded``) its one field over ``obs``."""
    fn = getattr(kernels, wrapper + ("_reference" if plain else ""))
    if wrapper != "min_dist_sq_expanded":
        return fn

    def one_field(px, py, obs, sx, sy, ap, **kw):
        return (fn(px, py, obs, ap, **kw),)

    return one_field


def _static_vs_plain(kernels, wrapper, device, seed):
    """A static sweep (K1 ``fused_min_dist_sq``, K2
    ``fused_min_dist_sq_expanded``, K4 ``min_dist_sq_expanded``, K6
    ``fused_min_dist_sq_broadcast``) against its plain version on every
    _static_cases case, at the launch's own samples per thread and at each
    one forced: bit for bit, NaN where the plain version has it. Returns
    the max abs error."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    kernel = _static_fields(kernels, wrapper)
    plain = _static_fields(kernels, wrapper, plain=True)
    err = 0.0
    for name, (px, py, obs, _vel, _dt, sx, sy), active in _static_cases(gen, device):
        B, S, T = px.shape
        if active is None:
            ap = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
            ap[0] = T
            ap = ap.to(device)
        else:
            ap = torch.full((B,), active, dtype=torch.int32, device=device)
        want = plain(px, py, obs, sx, sy, ap)
        own = _points_note(kernels, wrapper, B, S, T, device)
        for points in (None, *kernels.STATIC_POINTS):
            got = kernel(px, py, obs, sx, sy, ap, _points=points)
            torch.cuda.synchronize()
            err = max(err, _check_nan_equal(f"{wrapper} {name} {points}", got, want))
        if name.startswith("NaN"):
            assert bool(want[0][0].isnan().any()) and not bool(want[0][1].isnan().any())
            assert bool(want[0][2].isnan().all()), f"{name}: a NaN row was dropped"
        elif name.startswith("a point on") and wrapper == "fused_min_dist_sq":
            # the direct form is exactly +0 there (the expanded form cancels)
            assert float(want[0][0, 3, 5]) == 0.0 and float(want[1][1, 9, 2]) == 0.0
        elif name.startswith("values"):
            assert bool(want[0][0, 7, 2].isnan()) == (
                wrapper == "fused_min_dist_sq_broadcast"), f"{name}: the broadcast NaN"
        if not name.startswith(("NaN", "values")):
            _check_equal(name, want, want, active)  # the mask and d2 >= 0
        log(f"{wrapper} == plain at its own {own} and at each of "
            f"{kernels.STATIC_POINTS} samples per thread: {name}")
    return err


def _cpu_check(spec, buf, out, cpu_ties, custom_costs=()):
    """The same packed input through the port on the CPU (plain sweep)."""
    import torch

    from kompass_core_tpu_torch.ops.solver import _unpack_inputs, dwa_solve

    res = dwa_solve(spec, *_unpack_inputs(spec, torch.from_numpy(buf.copy())),
                    custom_costs=custom_costs)
    found, cost, best, n_adm = bool(out[0] > 0.5), float(out[1]), int(out[2]), int(out[3])
    assert found == bool(res.found), "found differs from the CPU"
    assert n_adm == int(res.num_admissible), "num_admissible differs from the CPU"
    if found:
        assert math.isclose(cost, float(res.cost), rel_tol=COST_REL), (
            f"cost {cost} vs CPU {float(res.cost)}")
    cbest = int(res.best_index)
    if best != cbest:
        costs = res.costs.numpy()
        assert abs(costs[best] - costs[cbest]) <= TIE_REL * abs(costs[cbest]), (
            f"winner {best} vs CPU {cbest} is not a tie")
        cpu_ties.append((best, cbest))


def run_slice(robot, dwa, ticks, kernels, cpu_ties):
    """Closed-loop ticks through DWA.loop_step, each checked against the
    CPU and counted as exactly one kernel launch."""
    circles = obstacle_circles()
    found = 0
    for i in range(ticks):
        before = kernels.fused_min_dist_sq.launches
        ok = dwa.loop_step(current_state=robot.state,
                           laser_scan=cast_scan(robot.state, circles))
        assert ok, f"tick {i}: loop_step returned False"
        assert kernels.fused_min_dist_sq.launches == before + 1, (
            f"tick {i}: {kernels.fused_min_dist_sq.launches - before} launches")
        spec, buf, out = dwa.last_solver_io
        shape = (spec.num_samples, spec.max_points, spec.scan_size, spec.seg_size)
        assert shape == SLICE_SHAPE, f"tick {i}: solved {shape}, not {SLICE_SHAPE}"
        _cpu_check(spec, buf, out, cpu_ties)
        found += dwa.has_result()
        apply_first_command(robot, dwa)
    return found


def check_no_sync_in_solve(dwa, robot):
    """The packed solve on a device-resident buffer makes no host sync."""
    import torch

    dwa.loop_step(current_state=robot.state,
                  laser_scan=cast_scan(robot.state, obstacle_circles()))
    spec, buf, _ = dwa.last_solver_io
    from kompass_core_tpu_torch.ops import make_packed_dwa_solver

    dev_buf = torch.from_numpy(buf.copy()).to(dwa.device)
    solve = make_packed_dwa_solver(spec, dwa.device)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve(dev_buf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode warns "called a synchronizing CUDA operation" per sync
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    assert not syncs, f"host syncs inside the solve: {syncs}"
    torch.cuda.synchronize()


def phase_slice(kernels, device):
    cpu_ties = []
    robot = make_robot()
    dwa = make_dwa(robot, device)
    check_no_sync_in_solve(dwa, robot)
    robot = make_robot()
    dwa = make_dwa(robot, device)
    start = goal_distance(robot)
    before = kernels.launch_counts()
    found = run_slice(robot, dwa, SLICE_TICKS, kernels, cpu_ties)
    launches = _launches_made(kernels, before)
    end = goal_distance(robot)
    log(f"slice (drop): {SLICE_TICKS} ticks, {found} found, launches {launches}, "
        f"goal distance {start:.3f} -> {end:.3f} m, CPU ties {len(cpu_ties)}")
    assert launches == _solves({"K1": SLICE_TICKS}, SLICE_TICKS), launches
    assert found == SLICE_TICKS, "the planner lost its way in an open corridor"
    assert end < start - 1.0, "the robot did not approach the goal"

    robot_t = make_robot()
    dwa_t = make_dwa(robot_t, device, drop_samples=False)
    found_t = run_slice(robot_t, dwa_t, TRUNCATE_TICKS, kernels, cpu_ties)
    log(f"slice (truncate): {TRUNCATE_TICKS} ticks, {found_t} found; "
        f"CPU ties in all: {len(cpu_ties)} {cpu_ties}")
    assert found_t == TRUNCATE_TICKS
    return launches


def phase_times(kernels, device, card):
    import torch

    robot = make_robot()
    dwa = make_dwa(robot, device)
    circles = obstacle_circles()
    lat = []
    for i in range(TIMED_WARMUP + TIMED_TICKS):
        scan = cast_scan(robot.state, circles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = dwa.loop_step(current_state=robot.state, laser_scan=scan)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        assert ok, f"timed tick {i} failed"
        if i >= TIMED_WARMUP:
            lat.append(dt_ms)
        apply_first_command(robot, dwa)
    lat.sort()
    p50 = statistics.median(lat)
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    log(f"tick latency over {len(lat)} ticks ({card}): median {p50:.4f} ms, "
        f"p99 {p99:.4f} ms, min {lat[0]:.4f} ms, max {lat[-1]:.4f} ms")
    return p50


# The static kernel's path shapes, timed by phase_static_times: (kernel,
# shape, B, S, T, O, G, active steps, distinct inputs). K1: the flagship
# tick's sweep (drop and truncate mode), the xla fleet solver's 64
# BASELINE scenarios, the cost evaluator's one pad row and 1024 segment
# slots; K2 (pallas) and K4 (pallas_v1, one launch per row set: G = 0)
# at the flagship and the fleet solver's 64 scenarios; K6 (pallas_vpu)
# at the flagship and the k-tick loop's 64 robots (768 + 384 rows)
STATIC_TIMED = (
    ("K1", "flagship", 1, 2025, 30, 512, 384, 30, KERNEL_INPUTS),
    ("K1", "flagship, truncated", 1, 2025, 30, 512, 384, 17, KERNEL_INPUTS),
    ("K1", f"{SOLVER_ROBOTS} robots", SOLVER_ROBOTS, 2025, 30, 512, 384, 30,
     FLEET_KERNEL_INPUTS),
    ("K1", "cost evaluator", 1, *EVAL_SHAPE[:2], 1, EVAL_SHAPE[2], EVAL_SHAPE[1], 4),
    ("K2", "flagship", 1, 2025, 30, 512, 384, 30, KERNEL_INPUTS),
    ("K2", f"{SOLVER_ROBOTS} robots", SOLVER_ROBOTS, 2025, 30, 512, 384, 30,
     FLEET_KERNEL_INPUTS),
    ("K4", "flagship", 1, 2025, 30, 512, 0, 30, KERNEL_INPUTS),
    ("K4", f"{SOLVER_ROBOTS} robots", SOLVER_ROBOTS, 2025, 30, 512, 0, 30,
     FLEET_KERNEL_INPUTS),
    ("K6", "flagship", 1, 2025, 30, 512, 384, 30, KERNEL_INPUTS),
    ("K6", f"{FLEET_ROBOTS} robots, k-tick loop", *FLEET_SHAPE, 30,
     FLEET_KERNEL_INPUTS),
)
STATIC_WRAPPERS = {"K1": "fused_min_dist_sq", "K2": "fused_min_dist_sq_expanded",
                   "K4": "min_dist_sq_expanded", "K6": "fused_min_dist_sq_broadcast"}
# FP32 instructions per pair: K1 2 FADD + 2 FMUL + FADD + min; K2 and K4
# 2 FMUL + FADD + FFMA + min (|o|^2 - 2 cross as one FFMA, exact below
# 1e18); K6 2 FMUL + 2 FADD + min
STATIC_PAIR_OPS = {"K1": 6, "K2": 5, "K4": 5, "K6": 5}


def _static_inputs(gen, device, key, B, S, T, O, G, active, count):
    """``count`` distinct inputs of a STATIC_TIMED row, as its wrapper
    takes them (K4: px, py, rows, ap)."""
    import torch

    ap = torch.full((B,), active, dtype=torch.int32, device=device)
    cases = (_moving_case(gen, device, B, S, T, O, G) for _ in range(count))
    if key == "K4":
        return [(px, py, obs, ap) for px, py, obs, *_ in cases]
    return [(px, py, obs, sx, sy, ap) for px, py, obs, _v, _d, sx, sy in cases]


def _points_note(kernels, wrapper, B, S, T, device):
    """The samples per thread the static kernel's launch of ``wrapper``
    takes for B robots' [S, T] points on this card (a tree where the
    wrapper takes ``_points``), else "one thread per point"."""
    import inspect

    import torch

    if "_points" not in inspect.signature(getattr(kernels, wrapper)).parameters:
        return "one thread per point"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return f"kPts = {kernels.sweep_points(B, S, T, sms)}"


def phase_static_times(kernels, device, card):
    """The static sweeps at their path shapes (STATIC_TIMED), each against
    its plain version in turns by back-to-back CUDA events, and by graph
    replay (printed beside them: at one robot the sweep takes less time on
    the card than its wrapper on the host), beside its bound, with the
    launch's samples per thread. Returns {"K1": (ms, plain ms, bound ms,
    bound by) at the flagship, "K2", "K4", "K6": the same}, ms by the
    events."""
    import torch

    gen = torch.Generator().manual_seed(2)
    results = {}
    for key, shape, B, S, T, O, G, active, count in STATIC_TIMED:
        wrapper = STATIC_WRAPPERS[key]
        kernel = getattr(kernels, wrapper)
        inputs = _static_inputs(gen, device, key, B, S, T, O, G, active, count)
        k_ms, p_ms, runs = _in_turns(kernel, getattr(kernels, wrapper + "_reference"),
                                     inputs, warm=min(5, count))
        g_ms = _graph_ms(kernel, inputs)
        b_ms, b_by = form_bound(inputs[0][0], O, inputs[0][-1], G, STATIC_PAIR_OPS[key],
                                STATIC_PAIR_OPS[key], fields=1 if key == "K4" else 2)
        log(f"{wrapper} ({key}) at the {shape} shape, B={B}, {S}x{T} vs {O}+{G} rows, "
            f"{active} active steps, {_points_note(kernels, wrapper, B, S, T, device)} "
            f"({card}): CUDA events over {count} distinct inputs back to back, in "
            f"turns {runs}: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms; graph replay "
            f"{g_ms:.5f} ms per call; bound {b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} "
            f"of the events' time, {b_ms / g_ms:.1%} of the replay's")
        if shape == "flagship":
            results[key] = (k_ms, p_ms, b_ms, b_by)
        del inputs
    return results


def _enqueue_ms(fn, inputs):
    """Host ms per call of ``fn`` over ``inputs`` without a sync between
    calls: the wrapper's and the launch's own cost on the host, while the
    card runs behind."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in inputs:
        fn(*args)
    ms = (time.perf_counter() - t0) * 1e3 / len(inputs)
    torch.cuda.synchronize()
    return ms


def phase_points_times(kernels, device, card):
    """A probe, not a phase of the smoke run (``chip_ab.py --points``):
    each static sweep by graph replay at each samples per thread the
    kernel takes, at each STATIC_TIMED shape (the alternative to
    sweep_points' choice), and at the flagship each launch's host enqueue
    time."""
    import torch

    gen = torch.Generator().manual_seed(12)
    for key, shape, B, S, T, O, G, active, count in STATIC_TIMED:
        if shape.endswith("truncated"):
            continue
        wrapper = STATIC_WRAPPERS[key]
        kernel = getattr(kernels, wrapper)
        inputs = _static_inputs(gen, device, key, B, S, T, O, G, active, count)
        times = {k: _graph_ms(lambda *a, k=k: kernel(*a, _points=k), inputs)
                 for k in kernels.STATIC_POINTS}
        log(f"{wrapper} ({key}) at the {shape} shape by samples per "
            f"thread, graph replay ms per call ({card}): "
            + ", ".join(f"kPts = {k} {t:.5f}" for k, t in times.items())
            + f"; the launch takes {_points_note(kernels, wrapper, B, S, T, device)}")
        if B == 1 and shape == "flagship":
            enqueue = {f"kPts = {k}": min(_enqueue_ms(
                lambda *a, k=k: kernel(*a, _points=k), inputs) for _ in range(3))
                for k in kernels.STATIC_POINTS}
            log(f"{wrapper} ({key}) at the {shape} shape, host enqueue ms "
                f"per call, best of 3 runs of {count} ({card}): "
                + ", ".join(f"{g} {t:.5f}" for g, t in enqueue.items()))
        del inputs


def _check_equal(name, got, want, active=None):
    """torch.equal of each output pair; returns the max abs difference
    (0 where both are inf)."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        both_inf = torch.isinf(g) & torch.isinf(w)
        err = max(err, float(torch.where(both_inf, 0.0, (g - w).abs()).max()))
        assert torch.equal(g, w), f"{name}: kernel != plain (max abs {err})"
        if active is not None:
            assert bool((g[..., active:] == math.inf).all()), f"{name}: mask"
            assert bool((g[..., :active] >= 0).all()), f"{name}: negative d2"
    return err


def phase_batched_k1(kernels, device):
    """The static sweep over a 64-robot batch at the fleet shapes equals
    64 one-robot launches and the plain version, bit for bit."""
    import torch

    B, S, T, O, G = FLEET_SHAPE
    gen = torch.Generator().manual_seed(3)
    cases = [_sweep_case(gen, device, S, T, O, G) for _ in range(B)]
    px, py, obs, sx, sy = (torch.stack(parts) for parts in zip(*cases))
    active = torch.randint(2, T + 1, (B,), generator=gen, dtype=torch.int32)
    ap = active.to(device)
    batch = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
    err = _check_equal("batched K1 vs plain", batch,
                       kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap))
    for b in range(B):
        one = kernels.fused_min_dist_sq(px[b], py[b], obs[b], sx[b], sy[b], ap[b])
        err = max(err, _check_equal(f"batched K1 robot {b}",
                                    tuple(f[b] for f in batch), one,
                                    int(active[b])))
    torch.cuda.synchronize()
    log(f"batched K1 == per-robot K1 == plain: B={B}, {S}x{T} points, "
        f"{O} + {G} rows")
    return err


def _moving_case(gen, device, B, S, T, O, G, span=10.0, vmax=1.5):
    import torch

    px, py, obs, sx, sy = (torch.stack(parts) for parts in zip(
        *[_sweep_case(gen, device, S, T, O, G, span) for _ in range(B)]))
    vel = ((torch.rand(B, O, 2, generator=gen) * 2 - 1) * vmax).to(device)
    dt = (0.05 + 0.1 * torch.rand(B, generator=gen)).to(device)
    return px, py, obs, vel, dt, sx, sy


def _non_finite(px, py, obs, vel, sx, sy):
    """NaN and +-inf in robot 0's points, obstacle rows, velocities and
    segment rows; robot 1 stays finite; robot 2 has one NaN obstacle row
    in its first tile of rows and a finite second tile."""
    nan, inf = float("nan"), float("inf")
    obs[2, 5, 1] = nan
    px[0, 3, 4], py[0, 7, 0], px[0, 11, -1] = nan, inf, -inf
    obs[0, 5, 0], obs[0, 9, 1], obs[0, -1] = nan, inf, -inf
    vel[0, 17, 1] = inf  # inf * tau at t = 0 is NaN
    sx[0, 2], sy[0, 4] = nan, -inf
    return px, py, obs, vel, sx, sy


def phase_moving_vs_plain(kernels, device):
    """The moving sweep (K3's port) against its plain version, and at
    zero velocity against K1, bit for bit."""
    import torch

    gen = torch.Generator().manual_seed(4)
    B, S, T, O, G = FLEET_SHAPE
    cases = []
    for active in (30, 17):
        cases.append((f"flagship moving active={active}",
                      _moving_case(gen, device, 1, 2025, 30, 512, 384), active))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 1, 2025, 30, 512, 384)
    obs[:, 400:] = 1e8
    vel[:, 400:] = 0.0
    cases.append(("112 pad rows (1e8, zero velocity)",
                  (px, py, obs, vel, dt, sx, sy), 30))
    cases.append(("O=700, G=333 (ragged tiles)",
                  _moving_case(gen, device, 1, 2025, 30, 700, 333), 30))
    cases.append(("O=1100, G=1025 (rows past one tile)",
                  _moving_case(gen, device, 2, 2025, 30, 1100, 1025), 30))
    cases.append(("S=1025 (samples past one block), B=2",
                  _moving_case(gen, device, 2, 1025, 30, 768, 384), 30))
    cases.append(("T=1, B=3", _moving_case(gen, device, 3, 2025, 1, 768, 384), 1))
    cases.append(("S*T=259 (ragged block), B=3",
                  _moving_case(gen, device, 3, 37, 7, 512, 384), 5))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 3, 300, 30, 1100, 384)
    cases.append(("NaN and +-inf points and rows (robots 0 and 2; robot 1 finite)",
                  (*_non_finite(px, py, obs, vel, sx, sy)[:4], dt, sx, sy), 30))
    cases.append((f"fleet shapes B={B}, O={O}",
                  _moving_case(gen, device, B, S, T, O, G), None))
    max_err = 0.0
    for name, (px, py, obs, vel, dt, sx, sy), active in cases:
        if active is None:
            ap = torch.randint(2, T + 1, (px.shape[0],), generator=gen,
                               dtype=torch.int32).to(device)
        else:
            ap = torch.full((px.shape[0],), active, dtype=torch.int32,
                            device=device)
        got = kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)
        want = kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap, vel, dt)
        torch.cuda.synchronize()
        if name.startswith("NaN"):
            for g, w in zip(got, want):
                assert torch.equal(g.isnan(), w.isnan()), f"{name}: NaN differs"
                assert torch.equal(g.nan_to_num(), w.nan_to_num()), name
            assert bool(got[0][0].isnan().any()) and not bool(got[0][1].isnan().any())
            assert bool(got[0][2].isnan().all()), f"{name}: a NaN row was dropped"
        else:
            max_err = max(max_err, _check_equal(name, got, want, active))
        log(f"moving kernel == plain: {name}")
    for shape in ((4, 2025, 30, 512, 384), FLEET_SHAPE):
        px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, *shape)
        ap = torch.randint(2, shape[2] + 1, (shape[0],), generator=gen,
                           dtype=torch.int32).to(device)
        got = kernels.fused_min_dist_sq_moving(px, py, obs, torch.zeros_like(vel),
                                               dt, sx, sy, ap)
        k1 = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
        torch.cuda.synchronize()
        max_err = max(max_err, _check_equal(f"zero velocity vs K1 {shape}", got, k1))
        log(f"moving kernel at zero velocity == K1: B, S, T, O, G = {shape}")
    return max_err


# --- the fleet slice ----------------------------------------------------------


def fleet_scene(robots=None):
    """Per robot (FLEET_ROBOTS by default): its lane's x offset, its path
    (the S-curve, shifted to the lane) and its posts. Corridor walls sit
    at the lane's x +- 5."""
    lanes = LANE_SPACING * np.arange(FLEET_ROBOTS if robots is None else robots)
    path = reference_path()
    paths = [path + (x, 0.0) for x in lanes]
    circles = np.stack([obstacle_circles() + (x, 0.0, 0.0) for x in lanes])
    return lanes, paths, circles


def cast_fleet_scans(states, lanes, circles):
    """[N, 512] ranges per robot against its own posts and corridor
    walls (no hit within range gives +inf), vectorized over the fleet."""
    angles = np.linspace(-np.pi, np.pi, RAYS, endpoint=False)
    th = states[:, 2:3] + angles  # [N, R]
    dx, dy = np.cos(th)[..., None], np.sin(th)[..., None]
    ox = circles[:, None, :, 0] - states[:, 0, None, None]  # [N, 1, C]
    oy = circles[:, None, :, 1] - states[:, 1, None, None]
    r = circles[:, None, :, 2]
    b = dx * ox + dy * oy
    disc = b * b - (ox * ox + oy * oy - r * r)
    t = b - np.sqrt(np.maximum(disc, 0.0))
    best = np.where((disc >= 0.0) & (t > 0.0), t, np.inf).min(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        for side in (-CORRIDOR_X, CORRIDOR_X):
            t = ((lanes + side)[:, None] - states[:, 0:1]) / dx[..., 0]
            best = np.where((t > 0.0) & (t < best), t, best)
    return np.where(best <= RANGE_MAX, best, np.inf).astype(np.float32), angles


def make_fleet(device, tracked=FLEET_TRACKED, backend="xla", robots=None,
               split=False, mesh=None):
    from kompass_core_tpu_torch.control import DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu_torch.parallel import DeviceFleet

    n = FLEET_ROBOTS if robots is None else robots
    robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.25, 0.4]))
              for _ in range(n)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=VX_MAX, max_acc=1.5, max_decel=2.5),
        omega_limits=AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0),
    )
    config = DWAConfig(
        max_linear_samples=SAMPLES, max_angular_samples=SAMPLES,
        prediction_horizon=HORIZON, control_horizon=CONTROL_HORIZON,
        control_time_step=DT,
    )
    fleet = DeviceFleet(robots, limits, config, RAYS, path_capacity=4608,
                        tracked_obstacles=tracked, split_mover_sweep=split,
                        **_placed(device, mesh))
    if backend != "xla":
        # the fleet solves with the JAX fleet's "xla"; its k-tick loop,
        # built from fleet.spec on the loop's first call, runs the
        # backend's kernels (its single tick keeps "xla")
        fleet.spec = dataclasses.replace(fleet.spec, solver=dataclasses.replace(
            fleet.spec.solver, backend=backend))
    lanes, paths, circles = fleet_scene(n)
    fleet.set_paths(paths)
    solver = fleet.spec.solver
    shape = (fleet._n, solver.num_samples, solver.max_points,
             solver.scan_size, solver.seg_size)
    # the scan bucket: the rays and the tracked slots (the split form's
    # movers sweep on their own: the rays alone), rounded up to 256 rows
    bucket = -(-(RAYS + (0 if split else tracked)) // 256) * 256
    assert shape[1:] == (*FLEET_SHAPE[1:3], bucket, FLEET_SHAPE[4]), f"fleet shapes {shape}"
    return fleet, lanes, circles


class FleetDrive:
    """The closed loop around a fleet: robots start at their lanes' path
    starts facing +y; each tick casts their scans, gives each its live
    mover (slot 0; slots 1..7 NaN, i.e. empty), ticks, and integrates the
    found commands for one control step on the host."""

    def __init__(self, lanes, circles, tracked):
        self.lanes, self.circles, self.tracked = lanes, circles, tracked
        n = len(lanes)
        self.states = np.zeros((n, 4), np.float32)
        self.states[:, 0] = lanes
        self.states[:, 2] = math.pi / 2
        self.vels = np.zeros((n, 3), np.float32)
        # a mover 2.5 m ahead and 2 m to the side of each robot, walking
        # across its path at 0.8 m/s
        self.movers = np.stack([lanes + 2.0, np.full(n, 2.5)], 1)
        self.mover_vel = np.array([-0.8, 0.0])
        self.min_clearance = math.inf

    def inputs(self):
        ranges, angles = cast_fleet_scans(self.states, self.lanes, self.circles)
        tracked = None
        if self.tracked:
            tracked = np.full((len(self.lanes), self.tracked, 4), np.nan,
                              np.float32)
            tracked[:, 0, 0:2] = self.movers
            tracked[:, 0, 2:4] = self.mover_vel
        return self.states, self.vels, ranges, angles, tracked

    def advance(self, out):
        go = out["found"]
        vx, om = np.where(go, out["vx"], 0.0), np.where(go, out["omega"], 0.0)
        s = self.states
        s[:, 0] += DT * vx * np.cos(s[:, 2])
        s[:, 1] += DT * vx * np.sin(s[:, 2])
        s[:, 2] += DT * om
        s[:, 3] = np.abs(vx)
        self.vels[:, 0], self.vels[:, 2] = vx, om
        self.movers += DT * self.mover_vel
        self.min_clearance = min(self.min_clearance, float(np.hypot(
            *(s[:, 0:2] - self.movers).T).min()))

    def goal_distance(self, paths_end):
        return np.hypot(*(self.states[:, 0:2] - paths_end).T)

    def advance_ticks(self, out, k):
        """Take the k-tick loop's final states and last commands, and move
        the movers k control steps on."""
        self.states = out["final_states"].astype(np.float32).copy()
        self.vels = np.stack([out[key][:, -1] for key in ("vx", "vy", "omega")],
                             axis=1).astype(np.float32)
        self.movers += k * DT * self.mover_vel


def sync_guarded(fn):
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("warn")``: it
    fails if anything inside synchronised the host with the card."""
    import torch

    def run(*args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing" in str(w.message)]
        assert not syncs, f"host syncs inside the fleet tick: {syncs}"
        run.calls += 1
        return result

    run.calls = 0
    return run


def _fleet_cpu_check(fleet, carry_before, out, tick, ties):
    """The sampled robots' rows against the port's tick on the CPU, fed
    the same inputs, path rows, config rows and carry rows."""
    import torch

    from kompass_core_tpu_torch.ops.fleet_solver import (
        FleetCarry, FleetConfig, FleetPaths, make_fleet_tick,
    )

    idx = torch.tensor(FLEET_CPU_ROBOTS)
    rows = [FleetPaths(*(t.cpu()[idx] for t in fleet._paths)),
            FleetConfig(*(t.cpu()[idx] for t in fleet._cfg)),
            FleetCarry(*(t[idx] for t in carry_before)),
            fleet._angles.cpu()[idx],
            torch.from_numpy(fleet._inputs[list(FLEET_CPU_ROBOTS)].copy())]
    _, cpu = make_fleet_tick(fleet.spec, "cpu")(*rows)
    _compare_cpu_rows(out, cpu, FLEET_CPU_ROBOTS, tick, ties)


def _compare_cpu_rows(out, cpu, robots, tick, ties, exact=()):
    """The card's output rows of ``robots`` against the CPU's [len(robots),
    F] rows: equal counts and flags (and ``exact`` columns), the cost
    within COST_REL, the command equal or a tie (recorded in ``ties``)."""
    from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS

    cpu = {k: cpu[:, i].numpy() for i, k in enumerate(OUT_FIELDS)}
    for j, r in enumerate(robots):
        for key in ("num_admissible", "active_points", "reached"):
            assert float(out[key][r]) == cpu[key][j], (
                f"tick {tick} robot {r}: {key} {out[key][r]} vs CPU {cpu[key][j]}")
        assert bool(out["found"][r]) == (cpu["found"][j] > 0.5), f"tick {tick} found"
        assert math.isclose(out["cost"][r], cpu["cost"][j], rel_tol=COST_REL,
                            abs_tol=1e-6), (
            f"tick {tick} robot {r}: cost {out['cost'][r]} vs CPU {cpu['cost'][j]}")
        cmd = [out[k][r] for k in ("vx", "vy", "omega")]
        cmd_cpu = [cpu[k][j] for k in ("vx", "vy", "omega")]
        if cmd != cmd_cpu:
            assert abs(out["cost"][r] - cpu["cost"][j]) <= TIE_REL * abs(cpu["cost"][j]), (
                f"tick {tick} robot {r}: command {cmd} vs CPU {cmd_cpu} is not a tie")
            ties.append((tick, r))
            continue
        for key in exact:
            assert float(out[key][r]) == cpu[key][j], (
                f"tick {tick} robot {r}: {key} {out[key][r]} vs CPU {cpu[key][j]}")


def phase_fleet(kernels, device):
    """The fleet slice: 64 robots, tracked movers, closed loop on cuda.
    The tick is one CUDA graph: the sync guard wraps the tick program,
    which runs for the capture's warm-up and recording (a capture fails on
    any host sync besides); every tick replays the graph, which launches
    K3 once. Returns the launches the card ran: the warm-up's and the
    replays'."""
    import torch

    fleet, lanes, circles = make_fleet(device)
    drive = FleetDrive(lanes, circles, FLEET_TRACKED)
    fleet._tick_fn = sync_guarded(fleet._tick_fn)
    ends = np.stack([p[-1] for p in fleet_scene()[1]])
    start = drive.goal_distance(ends)
    ties, found = [], 0
    start_counts = kernels.launch_counts()
    for tick in range(FLEET_TICKS):
        carry = [t.cpu() for t in fleet._carry]
        out = _tick_checked(kernels, fleet, tick, {"K3": 1},
                            lambda: fleet.tick(*drive.inputs()))
        for key, col in out.items():
            assert col.shape == (FLEET_ROBOTS,) and np.isfinite(col).all(), key
        if tick in FLEET_CPU_TICKS:
            _fleet_cpu_check(fleet, carry, out, tick, ties)
        found += int(out["found"].sum())
        drive.advance(out)
    made = _card_runs(_launches_made(kernels, start_counts), list(fleet.tick_graphs.values()))
    k3, k1 = made.get("K3", 0), made.get("K1", 0)
    torch.cuda.synchronize()
    end = drive.goal_distance(ends)
    log(f"fleet slice: {FLEET_ROBOTS} robots x {FLEET_TICKS} ticks, "
        f"{FLEET_TRACKED} tracked slots, one tick graph; moving-sweep launches {k3} "
        f"(the capture's warm-up and the replays), static {k1}; sync-checked tick "
        f"program calls {fleet._tick_fn.calls} (the warm-up and the capture); found "
        f"{found}/{FLEET_ROBOTS * FLEET_TICKS}; mean goal distance "
        f"{start.mean():.3f} -> {end.mean():.3f} m; min robot-mover distance "
        f"{drive.min_clearance:.3f} m; CPU-checked rows "
        f"{len(FLEET_CPU_TICKS) * len(FLEET_CPU_ROBOTS)}, ties {ties}")
    assert made == _solves({"K3": FLEET_TICKS + 1}, FLEET_TICKS + 1), made
    assert fleet._tick_fn.calls == 2
    assert found >= 0.9 * FLEET_ROBOTS * FLEET_TICKS, "the fleet lost its way"
    assert end.mean() < start.mean() - 1.0, "the fleet did not approach its goals"
    return made


def _time_fleet(device, tracked, card):
    """Host clock and CUDA events around each ``fleet.tick`` call (the
    input copy, the graph replay and the output copy, with the card idle
    while the host packs) over FLEET_TIMED_TICKS closed-loop ticks after
    10 warm-up ticks."""
    import torch

    fleet, lanes, circles = make_fleet(device, tracked)
    drive = FleetDrive(lanes, circles, tracked)
    events = []
    lat = []
    for i in range(TIMED_WARMUP + FLEET_TIMED_TICKS):
        inputs = drive.inputs()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fleet.tick(*inputs)  # ends in the output copy, a sync
        stop.record()
        dt_ms = (time.perf_counter() - t0) * 1e3
        if i >= TIMED_WARMUP:
            lat.append(dt_ms)
            events.append((start, stop))
        drive.advance(out)
    torch.cuda.synchronize()
    dev = sorted(s.elapsed_time(e) for s, e in events)
    lat.sort()
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    name = f"fleet tick, {FLEET_ROBOTS} robots, tracked_obstacles={tracked}"
    log(f"{name} ({card}): host clock over {len(lat)} ticks median "
        f"{statistics.median(lat):.4f} ms, p99 {p99:.4f} ms, min {lat[0]:.4f}, "
        f"max {lat[-1]:.4f}; {1e3 / statistics.median(lat):.2f} ticks/s, "
        f"{FLEET_ROBOTS * 1e3 / statistics.median(lat):.1f} robot-ticks/s; "
        f"CUDA events around the call median {statistics.median(dev):.4f} ms")
    return statistics.median(lat), p99


def phase_fleet_times(kernels, device, card):
    import torch

    _time_fleet(device, FLEET_TRACKED, card)
    _time_fleet(device, 0, card)

    B, S, T, O, G = FLEET_SHAPE
    gen = torch.Generator().manual_seed(5)
    ap = torch.full((B,), T, dtype=torch.int32, device=device)
    inputs = [(px, py, obs, sx, sy, ap, vel, dt) for px, py, obs, vel, dt, sx, sy in
              (_moving_case(gen, device, B, S, T, O, G)
               for _ in range(FLEET_KERNEL_INPUTS))]

    def kernel(px, py, obs, sx, sy, ap, vel, dt):
        return kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)

    k_ms, p_ms, runs = _in_turns(kernel, kernels.fused_min_dist_sq_reference, inputs)
    b_ms, b_by = sweep_bound(inputs[0][0], O, ap, segments=G, moving=True)
    log(f"fused_min_dist_sq_moving at B={B}, {S}x{T} vs {O}+{G} rows ({card}), "
        f"CUDA events over {FLEET_KERNEL_INPUTS} distinct inputs, in turns "
        f"{runs}: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms; bound {b_ms:.5f} ms "
        f"({b_by}), {b_ms / k_ms:.1%} of it")
    return k_ms, p_ms, b_ms, b_by


# --- the mapping slice --------------------------------------------------------

# Mapper_Dense_400x400 (kompass_core_tpu/benchmark/runner.py): 3600 rays
# into a 400 x 400 grid at 0.05 m; the Bayesian form uses the reference
# benchmark's sensor model (p_prior, p_empty, p_occupied, range_sure,
# range_max, wall_size)
MAP_SPEC = (400, 400, 3600, 0.05)
MAP_RAGGED = (333, 517, 1000, 0.05, 0.13, -0.21, 0.4)
MAP_RAYS = 3600
BAYES_SCALARS = (0.6, 0.1, 0.9, 0.1, 20.0, 0.2)
MAP_ROBOTS = 64
MAP_UPDATES = 30
MAP_CPU_UPDATES = (0, 10, 20, 29)
MAP_CPU_ROBOTS = (0, 21, 42, 63)
CLOUD_POINTS = 100_000
MAP_TIMED = 100
MAP_KERNEL_INPUTS = 10
MAP_FLEET_TIMED = 20

MAP_SOURCE = "kompass_core_tpu_torch/csrc/scan_to_grid.cu"
MAP_REPLACES = "kompass_core_tpu/ops/mapping.py:244"


class Pose2D:
    def __init__(self, x, y, yaw):
        self.x, self.y, self.yaw = x, y, yaw

    def pose_data(self):
        from kompass_core_tpu_torch.datatypes import PoseData

        pose = PoseData()
        pose.set_position(x=self.x, y=self.y, z=0.0)
        pose.set_yaw(self.yaw)
        return pose


def mapping_poses(n, stride=2):
    """Poses walking the S-curve, facing along it."""
    path = reference_path()
    poses = []
    for k in range(n):
        i = (stride * k) % (len(path) - 1)
        (x0, y0), (x1, y1) = path[i], path[i + 1]
        poses.append(Pose2D(x0, y0, math.atan2(y1 - y0, x1 - x0)))
    return poses


def scan_model(**overrides):
    from kompass_core_tpu_torch.datatypes import ScanModelConfig

    p_prior, _, p_occupied, range_sure, range_max, wall_size = BAYES_SCALARS
    kw = dict(p_prior=p_prior, p_occupied=p_occupied, range_sure=range_sure,
              range_max=range_max, wall_size=wall_size)
    kw.update(overrides)
    return ScanModelConfig(**kw)  # p_empty = 1 - p_occupied = 0.1


def cloud_points(seed):
    """Mapper_PointCloud_100k's cloud: ranges 0.5-9.9 m, z in +-0.5 m."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 9.9, CLOUD_POINTS)
    a = rng.uniform(0, 2 * np.pi, CLOUD_POINTS)
    return np.stack([r * np.cos(a), r * np.sin(a),
                     rng.uniform(-0.5, 0.5, CLOUD_POINTS)], 1).astype(np.float32)


def _map_ranges(spec, robots, seed):
    """[robots, B] ranges of 0.5-9.9 m with 0, NaN and +inf beams."""
    import torch

    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 9.9, (robots, spec.num_bins)).astype(np.float32)
    r[:, ::97] = 0.0
    r[:, 7::211], r[:, 13::307] = np.nan, np.inf
    return torch.from_numpy(r)


def _map_inputs(spec, ranges, device, seed):
    """The per-cell pass's inputs as the mapper builds them."""
    import torch

    from kompass_core_tpu_torch.ops import mapping

    geo = mapping._geometry_for(spec, 0.0, device)
    tables, endpoint = mapping._beam_side(spec, geo, ranges.to(device))
    rng = np.random.default_rng(seed)
    prev = torch.from_numpy(rng.uniform(
        0.05, 0.95, (ranges.shape[0], spec.grid_height, spec.grid_width)
    ).astype(np.float32)).to(device)
    return geo, tables, endpoint, prev, mapping._params(device, *BAYES_SCALARS)


def _check_grids_equal(name, got, want):
    """torch.equal of each output pair; returns the max abs difference."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        err = max(err, float((g.double() - w.double()).abs().max()))
        assert torch.equal(g, w), f"{name}: kernel != plain (max abs {err})"
    return err


def boundary_tables(spec, geo):
    """[1, B, 4] tables whose beam b ends in the farthest cell whose
    nearest bin is b (the sensor cell for a bin no cell reads): that cell
    lies on its line test's t = L bound, the cells beside it on the
    diamond's edges."""
    import torch

    base = geo.base.cpu().reshape(-1).long()
    dist = geo.dist_m.cpu().reshape(-1)
    B, W = spec.num_bins, spec.grid_width
    far = torch.full((B,), -1.0).scatter_reduce(0, base, dist, "amax")
    cell = torch.zeros(B, dtype=torch.long)
    hit = dist == far[base]
    cell[base[hit]] = torch.nonzero(hit)[:, 0]
    si, sj = spec.start_cell
    e_i = torch.where(far >= 0, cell // W, si).to(torch.int32)
    e_j = torch.where(far >= 0, cell % W, sj).to(torch.int32)
    r = torch.rand(B, generator=torch.Generator().manual_seed(0)) * 5.0
    return torch.stack([e_i, e_j, r.view(torch.int32), (far >= 0).to(torch.int32)],
                       -1)[None].contiguous()


def _check_beam_pass(kernels, name, geo, tables, endpoint, start_cell):
    """K5's first launch, the beam pass, against ``line_test_bounds`` on
    the same card tensors, bit for bit."""
    import torch

    si, sj = start_cell
    _, _, got = kernels._scan_to_grid_cells_cuda(geo.base, geo.dist_m, tables,
                                                 endpoint, start_cell, None, None)
    want = kernels.line_test_bounds((tables[..., 0] - si).float(),
                                    (tables[..., 1] - sj).float())
    torch.cuda.synchronize()
    assert torch.equal(got[..., :3], want.view(torch.int32)), (
        f"{name}: beam pass != line_test_bounds")
    assert not bool(got[..., 3].any()), f"{name}: beam pass padding"
    log(f"K5 beam pass == line_test_bounds: {name}")


def phase_mapper_kernel_vs_plain(kernels, device):
    """K5 and its plain version on the same card tensors must be equal,
    in the plain and the Bayesian form, and the beam pass against
    ``line_test_bounds``."""
    import torch

    from kompass_core_tpu_torch.ops.mapping import MapperSpec

    full, ragged = MapperSpec(*MAP_SPEC), MapperSpec(*MAP_RAGGED)

    def shape(spec):
        return f"{spec.grid_height}x{spec.grid_width}/{spec.num_bins}"

    cases = [
        (f"{shape(full)} with 0, NaN and +inf beams", full, 1),
        (f"{shape(ragged)}, offset rotated laser", ragged, 1),
        (f"{shape(full)}, a batch of {MAP_ROBOTS} robots", full, MAP_ROBOTS),
        (f"{shape(full)}, every beam ending on a line-test boundary cell", full, 0),
        (f"{shape(ragged)}, every beam ending on a line-test boundary cell", ragged, 0),
    ]
    max_err = 0.0
    for seed, (name, spec, robots) in enumerate(cases):
        geo, tables, endpoint, prev, params = _map_inputs(
            spec, _map_ranges(spec, max(robots, 1), seed), device, seed)
        if robots == 0:
            tables = boundary_tables(spec, geo).to(device)
        _check_beam_pass(kernels, name, geo, tables, endpoint, spec.start_cell)
        for bayes in (False, True):
            extra = (prev, params) if bayes else ()
            form = "Bayesian" if bayes else "plain"
            want = kernels.scan_to_grid_cells_reference(
                geo.base, geo.dist_m, tables, endpoint, spec.start_cell, *extra)
            want = want if bayes else (want,)
            got = kernels.scan_to_grid_cells(geo.base, geo.dist_m, tables,
                                             endpoint, spec.start_cell, *extra)
            got = got if bayes else (got,)
            max_err = max(max_err, _check_grids_equal(f"{name} {form}", got, want))
            occ = got[0]
            codes = set(occ.unique().tolist())
            assert {0, 100} <= codes <= {-1, 0, 100}, f"{name}: codes {codes}"
            if bayes:
                prob = got[1]
                assert bool(((prob > 0) & (prob < 1)).all()), f"{name}: prob range"
            for b in range(robots if robots > 1 else 0):
                one = kernels.scan_to_grid_cells(
                    geo.base, geo.dist_m, tables[b:b + 1].contiguous(),
                    endpoint[b:b + 1].contiguous(), spec.start_cell,
                    *((prev[b:b + 1].contiguous(), params) if bayes else ()))
                one = one if bayes else (one,)
                max_err = max(max_err, _check_grids_equal(
                    f"{name} {form} robot {b}", [g[b] for g in got],
                    [o[0] for o in one]))
            log(f"K5 == plain ({form}): {name}"
                + (f"; batch == {robots} one-robot launches" if robots > 1 else ""))
    geo, tables, endpoint, _, _ = _map_inputs(full, _map_ranges(full, 2, 9), device, 9)
    gen = torch.Generator().manual_seed(9)
    tables[..., :2] = torch.randint(-2**15, 2**15, tables[..., :2].shape, generator=gen,
                                    dtype=torch.int32).to(device)
    _check_beam_pass(kernels, "endpoints across the 15-bit clip range, 2 robots",
                     geo, tables, endpoint, full.start_cell)
    return max_err


def _mapper_state(mapper):
    prev = None if mapper._prev_prob is None else mapper._prev_prob.cpu()
    return (mapper._spec, prev, mapper._pose_robot_in_world, mapper.processed,
            mapper.is_pointcloud)


def _device_ranges(mapper, scan, device):
    """The uniform ranges ``mapper`` computes from ``scan`` on ``device``."""
    import torch

    from kompass_core_tpu_torch.datatypes import PointCloudData
    from kompass_core_tpu_torch.ops import mapping

    if isinstance(scan, PointCloudData):
        m = mapper.scan_model
        return mapping.get_pointcloud_to_scan(mapper._spec.num_bins, device)(
            scan.points, m.range_max, m.min_height, m.max_height)
    return torch.from_numpy(mapper._uniform_ranges(scan)).to(device)


def _explained_cells(spec, ranges_gpu, ranges_cpu):
    """(number of beams whose table row differs between the devices, the
    cells such a beam can change: those reading it as a candidate and the
    endpoint cells that differ)."""
    import torch

    from kompass_core_tpu_torch.ops import kernels, mapping

    cpu = torch.device("cpu")
    geo = mapping._geometry_for(spec, 0.0, cpu)
    t_gpu, e_gpu = mapping._beam_side(spec, geo, ranges_gpu.cpu().reshape(1, -1))
    t_cpu, e_cpu = mapping._beam_side(spec, geo, ranges_cpu.reshape(1, -1))
    t_dev, e_dev = mapping._beam_side(
        spec, mapping._geometry_for(spec, 0.0, ranges_gpu.device),
        ranges_gpu.reshape(1, -1))
    assert torch.equal(t_dev.cpu(), t_gpu) and torch.equal(e_dev.cpu(), e_gpu), (
        "the card's beam side differs from the CPU's on the same ranges")
    differs = (t_gpu != t_cpu).any(dim=-1)[0]  # [B]
    k = torch.arange(kernels.CANDIDATES) - kernels.CANDIDATES // 2
    bins = torch.remainder(geo.base.long()[..., None] + k, spec.num_bins)
    explained = differs[bins].any(dim=-1) | (e_gpu != e_cpu)[0]
    return int(differs.sum()), explained


def _mapper_cpu_check(mapper, state, pose, scan, what):
    """The same update run by the port on the CPU from the card mapper's
    state before it: beam tables first, then every layer. Returns the
    number of beams whose table differs between the devices."""
    import torch

    from kompass_core_tpu_torch.mapping import LocalMapper

    cpu = LocalMapper(mapper.config, mapper.scan_model,
                      mapper.pose_laserscanner_in_robot, device="cpu")
    spec, prev, pose_before, processed, is_pointcloud = state
    if processed:
        cpu._spec, cpu._prev_prob = spec, prev
        cpu._pose_robot_in_world, cpu.processed = pose_before, True
        cpu.is_pointcloud = is_pointcloud
    cpu.update_from_scan(pose, scan)
    n_diff, explained = _explained_cells(
        mapper._spec, _device_ranges(mapper, scan, mapper.device),
        _device_ranges(cpu, scan, torch.device("cpu")))
    explained = explained.numpy()
    layers = [("occupancy", mapper.occupancy, cpu.occupancy),
              ("probabilistic occupancy", mapper.probabilistic_occupancy,
               cpu.probabilistic_occupancy)]
    if mapper.config.baysian_update:
        layers.append(("probability", mapper._prev_prob.cpu().numpy(),
                       cpu._prev_prob.numpy()))
        warped = mapper.previous_grid_prob_transformed
        assert np.array_equal(warped, cpu.previous_grid_prob_transformed), (
            f"{what}: the warped grid differs from the CPU")
    for name, g, c in layers:
        bad = (g != c) & ~explained
        assert not bad.any(), (
            f"{what}: {int(bad.sum())} {name} cells differ from the CPU that no "
            f"differing beam explains ({n_diff} beams differ)")
    return n_diff


def _assert_grid(mapper, what):
    occ = mapper.occupancy
    assert occ.shape == (MAP_SPEC[0], MAP_SPEC[1]) and occ.dtype == np.int32, what
    assert set(np.unique(occ).tolist()) <= {-1, 0, 100}, what
    assert (occ == 100).any() and (occ == 0).any(), f"{what}: no hits or no free cells"
    if mapper.config.baysian_update:
        prob = mapper._prev_prob  # repeated evidence saturates at 0 or 1
        assert bool(((prob >= 0) & (prob <= 1)).all()), f"{what}: probabilities"


def phase_mapping(kernels, device):
    """The mapping slice: a Bayesian 400 x 400 LocalMapper walking the
    S-curve for 30 updates, one 100k-point cloud update, and one call of
    each 64-robot fleet mapper, on cuda, held against the CPU."""
    import torch

    from kompass_core_tpu_torch.datatypes import PointCloudData
    from kompass_core_tpu_torch.mapping import LocalMapper, MapConfig
    from kompass_core_tpu_torch.ops import mapping

    height, width, bins, res = MAP_SPEC
    mapper = LocalMapper(MapConfig(width=width * res, height=height * res,
                                   resolution=res, baysian_update=True),
                         scan_model(), device=device)
    circles = obstacle_circles()
    beam_diffs = []
    for k, pose in enumerate(mapping_poses(MAP_UPDATES)):
        scan = cast_scan(pose, circles, MAP_RAYS)
        state = _mapper_state(mapper) if k in MAP_CPU_UPDATES else None
        before = kernels.scan_to_grid_cells.launches
        mapper.update_from_scan(pose.pose_data(), scan)
        assert kernels.scan_to_grid_cells.launches == before + 1, (
            f"update {k}: {kernels.scan_to_grid_cells.launches - before} K5 launches")
        _assert_grid(mapper, f"update {k}")
        if state is not None:
            beam_diffs.append(_mapper_cpu_check(mapper, state, pose.pose_data(),
                                                scan, f"update {k}"))
    assert mapper._spec == mapping.MapperSpec(height, width, bins, res)
    log(f"mapping slice: {MAP_UPDATES} Bayesian updates of {height}x{width} from "
        f"{MAP_RAYS} rays; CPU-checked updates {list(MAP_CPU_UPDATES)}, beams "
        f"whose table differs between card and CPU {beam_diffs}")

    cloud = LocalMapper(MapConfig(width=width * res, height=height * res,
                                  resolution=res),
                        scan_model(angle_step=2 * np.pi / bins, range_max=10.0,
                                   min_height=-1.0, max_height=1.0),
                        device=device)
    scan = PointCloudData(points=cloud_points(7))
    before = kernels.scan_to_grid_cells.launches
    cloud.update_from_scan(Pose2D(0.0, 0.0, 0.0).pose_data(), scan)
    assert kernels.scan_to_grid_cells.launches == before + 1
    _assert_grid(cloud, "cloud update")
    cloud_diffs = _mapper_cpu_check(cloud, _mapper_state(cloud), Pose2D(
        0.0, 0.0, 0.0).pose_data(), scan, "cloud update")
    log(f"cloud update: {CLOUD_POINTS} points into {height}x{width}/{bins}; "
        f"beams whose table differs between card and CPU {cloud_diffs}")

    spec = mapping.MapperSpec(*MAP_SPEC)
    ranges = _map_ranges(spec, MAP_ROBOTS, 11)
    prev = torch.from_numpy(np.random.default_rng(12).uniform(
        0.05, 0.95, (MAP_ROBOTS, height, width)).astype(np.float32))
    rows = list(MAP_CPU_ROBOTS)
    fleet_diffs = []
    for bayes in (False, True):
        before = kernels.scan_to_grid_cells.launches
        if bayes:
            out = mapping.get_scan_to_grid_bayesian_fleet(spec, device)(
                ranges, prev, *BAYES_SCALARS)
        else:
            out = (mapping.get_scan_to_grid_fleet(spec, device)(ranges),)
        assert kernels.scan_to_grid_cells.launches == before + 1
        if bayes:
            cpu = mapping.get_scan_to_grid_bayesian_fleet(spec, "cpu")(
                ranges[rows], prev[rows], *BAYES_SCALARS)
        else:
            cpu = (mapping.get_scan_to_grid_fleet(spec, "cpu")(ranges[rows]),)
        assert out[0].shape == (MAP_ROBOTS, height, width)
        for j, r in enumerate(rows):
            n_diff, explained = _explained_cells(spec, ranges[r].to(device), ranges[r])
            fleet_diffs.append(n_diff)
            for g, c in zip(out, cpu):
                bad = (g[r].cpu() != c[j]) & ~explained
                assert not bad.any(), f"fleet robot {r}: {int(bad.sum())} cells differ"
    log(f"fleet mappers: {MAP_ROBOTS} robots x {height}x{width}/{bins}, plain and "
        f"Bayesian, one launch each; robots {rows} equal the CPU (beams whose "
        f"table differs: {fleet_diffs})")


def _percentiles(lat):
    lat = sorted(lat)
    return statistics.median(lat), lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]


def phase_mapping_times(kernels, device, card):
    """update_from_scan latency, its host parts, K5 against its plain
    version, and the 64-robot fleet mapper."""
    import torch

    from kompass_core_tpu_torch.mapping import LocalMapper, MapConfig
    from kompass_core_tpu_torch.ops import mapping

    height, width, bins, res = MAP_SPEC
    circles = obstacle_circles()
    poses = mapping_poses(TIMED_WARMUP + MAP_TIMED, stride=1)
    scans = [cast_scan(p, circles, MAP_RAYS) for p in poses]
    for bayes in (True, False):
        mapper = LocalMapper(MapConfig(width=width * res, height=height * res,
                                       resolution=res, baysian_update=bayes),
                             scan_model(), device=device)
        lat = []
        for i, (pose, scan) in enumerate(zip(poses, scans)):
            pose = pose.pose_data()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mapper.update_from_scan(pose, scan)
            torch.cuda.synchronize()
            if i >= TIMED_WARMUP:
                lat.append((time.perf_counter() - t0) * 1e3)
        p50, p99 = _percentiles(lat)
        log(f"update_from_scan ({'Bayesian' if bayes else 'plain'}, {height}x{width}"
            f"/{bins}, {card}): host clock over {len(lat)} updates median "
            f"{p50:.4f} ms, p99 {p99:.4f} ms, min {min(lat):.4f}, max {max(lat):.4f}")

    # the host parts of one update
    def host_ms(fn, reps=50):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    scan, limit = scans[0], mapper.config.filter_limit
    filtered = np.minimum(limit, np.maximum(0.0, scan.ranges))
    r_host = mapping.resample_scan_uniform(scan.angles, filtered, bins, limit)
    grid = torch.zeros((2, height, width), dtype=torch.int32, device=device)
    parts = {
        "resample_scan_uniform": host_ms(lambda: mapping.resample_scan_uniform(
            scan.angles, filtered, bins, limit)),
        "H2D ranges (14.4 KB)": host_ms(lambda: torch.from_numpy(r_host).to(device)),
        "D2H two int32 grids (1.28 MB)": host_ms(lambda: grid.cpu().numpy()),
    }
    log(f"update_from_scan host parts ({card}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))

    spec = mapping.MapperSpec(*MAP_SPEC)
    results = {}
    for robots in (1, MAP_ROBOTS):
        inputs = []
        for i in range(MAP_KERNEL_INPUTS):
            geo, tables, endpoint, prev, params = _map_inputs(
                spec, _map_ranges(spec, robots, 20 + i), device, i)
            inputs.append((geo.base, geo.dist_m, tables, endpoint, spec.start_cell,
                           prev, params))
        k_ms, p_ms, runs = _in_turns(kernels.scan_to_grid_cells,
                                     kernels.scan_to_grid_cells_reference, inputs)
        b_ms, b_by = cells_bound(robots, height, width, bins)
        results[robots] = (k_ms, p_ms, b_ms, b_by)
        log(f"scan_to_grid_cells (Bayesian) at {robots} x {height}x{width}/{bins} "
            f"({card}), CUDA events over {MAP_KERNEL_INPUTS} distinct inputs, in "
            f"turns {runs}: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} of it")

    ranges = _map_ranges(spec, MAP_ROBOTS, 30).to(device)
    prev = torch.full((MAP_ROBOTS, height, width), 0.6, device=device)
    fleet = mapping.get_scan_to_grid_bayesian_fleet(spec, device)
    lat = []
    for i in range(3 + MAP_FLEET_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        occ, prob = fleet(ranges, prev, *BAYES_SCALARS)
        torch.cuda.synchronize()
        if i >= 3:
            lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = _percentiles(lat)
    log(f"Bayesian fleet mapper, {MAP_ROBOTS} robots x {height}x{width}/{bins}, "
        f"device-resident inputs ({card}): host clock over {len(lat)} calls median "
        f"{p50:.4f} ms, p99 {p99:.4f} ms")
    return results[MAP_ROBOTS]


# --- the expanded sweeps and the scenario-batched solver slice ----------------


def _expanded_pair(kernels, px, py, obs, sx, sy, ap, plain=False):
    """(K2's two fields, K4 over the obstacle rows, K4 over the segment
    rows): the kernels, or with ``plain`` their plain versions."""
    import torch

    seg = torch.stack([sx, sy], dim=-1).contiguous()
    if plain:
        k2, k4 = (kernels.fused_min_dist_sq_expanded_reference,
                  kernels.min_dist_sq_expanded_reference)
    else:
        k2, k4 = kernels.fused_min_dist_sq_expanded, kernels.min_dist_sq_expanded
    return k2(px, py, obs, sx, sy, ap), k4(px, py, obs, ap), k4(px, py, seg, ap)


def phase_expanded_vs_plain(kernels, device):
    """K2 and K4 against their plain versions on the same card tensors,
    bit for bit; K4 over either row set gives K2's field; both on the
    static kernel's edge cases at each samples per thread."""
    import torch

    S, T, O, G = SLICE_SHAPE
    gen = torch.Generator().manual_seed(6)
    cases = []
    for active in (T, 17):
        cases.append((f"flagship active={active}",
                      _moving_case(gen, device, 1, S, T, O, G), active))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 1, S, T, O, G)
    obs[:, O - 112:] = 1e8
    sx[:, G - 83:], sy[:, G - 83:] = 1e8, 1e8
    cases.append(("pad rows at 1e8 (112 obstacle, 83 segment)",
                  (px, py, obs, vel, dt, sx, sy), T))
    cases.append(("O=700, G=333 (ragged tiles)",
                  _moving_case(gen, device, 1, S, T, 700, 333), T))
    cases.append(("S*T=259 (ragged block), B=3",
                  _moving_case(gen, device, 3, 37, 7, O, G), 5))
    errs = [0.0, 0.0]
    for name, (px, py, obs, _vel, _dt, sx, sy), active in cases:
        ap = torch.full((px.shape[0],), active, dtype=torch.int32, device=device)
        k2, k4o, k4s = _expanded_pair(kernels, px, py, obs, sx, sy, ap)
        w2, w4o, w4s = _expanded_pair(kernels, px, py, obs, sx, sy, ap, plain=True)
        torch.cuda.synchronize()
        errs[0] = max(errs[0], _check_equal(f"K2 {name}", k2, w2, active))
        errs[1] = max(errs[1], _check_equal(f"K4 {name}", (k4o, k4s), (w4o, w4s),
                                            active))
        assert torch.equal(k4o, k2[0]) and torch.equal(k4s, k2[1]), (
            f"{name}: K4's fields differ from K2's")
        log(f"K2 == plain, K4 == plain == K2's fields: {name}")

    B = SOLVER_ROBOTS
    px, py, obs, _vel, _dt, sx, sy = _moving_case(gen, device, B, S, T, O, G)
    active = torch.randint(2, T + 1, (B,), generator=gen, dtype=torch.int32)
    ap = active.to(device)
    batch = _expanded_pair(kernels, px, py, obs, sx, sy, ap)
    want = _expanded_pair(kernels, px, py, obs, sx, sy, ap, plain=True)
    errs[0] = max(errs[0], _check_equal("batched K2 vs plain", batch[0], want[0]))
    errs[1] = max(errs[1], _check_equal("batched K4 vs plain", batch[1:], want[1:]))
    for b in range(B):
        one = _expanded_pair(kernels, px[b], py[b], obs[b], sx[b], sy[b], ap[b])
        errs[0] = max(errs[0], _check_equal(
            f"batched K2 robot {b}", tuple(f[b] for f in batch[0]), one[0],
            int(active[b])))
        errs[1] = max(errs[1], _check_equal(
            f"batched K4 robot {b}", (batch[1][b], batch[2][b]), one[1:],
            int(active[b])))
    torch.cuda.synchronize()
    log(f"batched K2 and K4 == per-robot launches == plain: B={B}, {S}x{T} points, "
        f"{O} + {G} rows")
    errs[0] = max(errs[0], _static_vs_plain(kernels, "fused_min_dist_sq_expanded",
                                            device, 11))
    errs[1] = max(errs[1], _static_vs_plain(kernels, "min_dist_sq_expanded", device, 15))
    return errs


BASELINE_SHAPE = (45, 30, 512, 384)  # samples per axis, steps, scan and segment slots


def baseline_spec(backend):
    """``kompass_core_tpu/benchmark/baseline.py``'s flagship solve (45 x 45
    samples, 30 steps, 512 obstacle and 384 segment slots, drop mode) as
    the port's ``SolverSpec`` with ``backend``."""
    from kompass_core_tpu_torch.ops.solver import SolverSpec

    samples, steps, scan, segments = BASELINE_SHAPE
    return SolverSpec(is_omni=False, n_vx=samples, n_vy=1, n_omega=samples,
                      max_points=steps, num_ctrl_points=6, scan_size=scan,
                      seg_size=segments, drop_samples=True, backend=backend)


def baseline_batches(spec, count, seed=0):
    """``count`` distinct [SOLVER_ROBOTS, L] batches: the same scenarios
    with the robots' x moved by 1e-4 m per batch, as ``bench.py`` makes
    them."""
    rng = np.random.default_rng(seed)
    base = np.stack([baseline_scenario(spec, rng, i) for i in range(SOLVER_ROBOTS)])
    batches = []
    for k in range(count):
        v = base.copy()
        v[:, 0] += np.float32(1e-4 * k)
        batches.append(v)
    return batches


def _rows_agree(out, ref, what):
    """Two packed output matrices of the same inputs: the same found and
    num_admissible, the cost within COST_REL, the winner the same or a
    tie. Returns (rows bit-equal, winners that differ)."""
    assert out.shape == ref.shape, what
    ties = 0
    for r, (o, c) in enumerate(zip(out, ref)):
        assert o[0] == c[0] and o[3] == c[3], f"{what} row {r}: found / admissible"
        if o[0] > 0.5:
            assert math.isclose(o[1], c[1], rel_tol=COST_REL), f"{what} row {r}: cost"
        if o[2] != c[2]:
            assert abs(o[1] - c[1]) <= TIE_REL * abs(c[1]), f"{what} row {r}: winner"
            ties += 1
    return int((out == ref).all(axis=1).sum()), ties


def phase_fleet_solver(kernels, device):
    """The scenario-batched solver slice on cuda: make_fleet_solver with
    64 BASELINE scenarios per call for each backend."""
    from kompass_core_tpu_torch.parallel import make_fleet_solver

    counters = kernels.SWEEP_KERNELS
    expect = {"xla": {"K1": 1}, "pallas": {"K2": 1}, "pallas_v1": {"K4": 2}}
    ties = []
    for backend in SOLVER_BACKENDS:
        spec = baseline_spec(backend)
        out_size = 4 + 3 * (spec.max_points - 1) + 2 * spec.max_points
        solve = make_fleet_solver(spec, device)
        found = 0
        for k, bufs in enumerate(baseline_batches(spec, SOLVER_BATCHES)):
            before = {n: c.launches for n, c in counters.items()}
            out = solve(bufs).cpu().numpy()
            made = {n: c.launches - before[n] for n, c in counters.items()}
            assert {n: v for n, v in made.items() if v} == expect[backend], (
                f"{backend} call {k}: launches {made}")
            assert out.shape == (SOLVER_ROBOTS, out_size), out.shape
            assert np.isfinite(out[:, 4:]).all(), f"{backend} call {k}: non-finite"
            found += int((out[:, 0] > 0.5).sum())
            if k == 0:
                for r in SOLVER_CPU_ROWS:
                    _cpu_check(spec, bufs[r], out[r], ties)
        log(f"fleet solver ({backend}): {SOLVER_BATCHES} calls x {SOLVER_ROBOTS} "
            f"scenarios, {found} found, launches per call {expect[backend]}; "
            f"rows {list(SOLVER_CPU_ROWS)} of the first call agree with the CPU")
        assert found >= 0.9 * SOLVER_BATCHES * SOLVER_ROBOTS, f"{backend}: found"
    log(f"fleet solver CPU ties: {ties}")

    spec = baseline_spec("xla")
    rows = np.concatenate(baseline_batches(spec, 3, seed=1))[:SOLVER_RAGGED]
    chunks = -(-SOLVER_RAGGED // SOLVER_CHUNK)
    before = kernels.fused_min_dist_sq.launches
    chunked = make_fleet_solver(spec, device, chunk_size=SOLVER_CHUNK)(rows)
    chunked = chunked.cpu().numpy()
    assert kernels.fused_min_dist_sq.launches == before + chunks, "chunked launches"
    whole = make_fleet_solver(spec, device, chunk_size=None)(rows).cpu().numpy()
    equal, n_ties = _rows_agree(chunked, whole, "chunked vs one dispatch")
    log(f"fleet solver, {SOLVER_RAGGED} rows in chunks of {SOLVER_CHUNK} ({chunks} "
        f"launches, tail padded) vs one dispatch: {equal} of {SOLVER_RAGGED} rows "
        f"bit-equal, winner ties {n_ties}")


def phase_evaluator(kernels, device):
    """The standalone cost evaluator at CostEvaluator_5k_Trajs's size on
    cuda; a sample of rows against the CPU."""
    import torch

    from kompass_core_tpu_torch.ops.solver import get_cost_evaluator

    S, T, G = EVAL_SHAPE
    params, args = evaluator_inputs(device, *EVAL_SHAPE[:2])
    dev_args = [torch.from_numpy(np.asarray(a)).to(device) for a in args]
    before = kernels.fused_min_dist_sq.launches
    res = get_cost_evaluator(device, with_obstacles=False)(params, *dev_args)
    costs = res.costs.cpu()
    assert kernels.fused_min_dist_sq.launches == before + 1, "evaluator launches"
    assert costs.shape == (S,) and bool(torch.isfinite(costs).all())
    assert bool(res.found) and int(res.num_admissible) == S
    assert int(res.best_index) == int(torch.argmin(costs))
    rows = np.linspace(0, S - 1, EVAL_CPU_ROWS).astype(np.int64)
    cpu_params, _ = evaluator_inputs("cpu", *EVAL_SHAPE[:2])
    cpu = get_cost_evaluator("cpu", with_obstacles=False)(
        cpu_params, *(a[rows] for a in args[:3]), *args[3:]).costs
    got = costs[torch.from_numpy(rows)]
    np.testing.assert_allclose(got.numpy(), cpu.numpy(), rtol=COST_REL)
    log(f"cost evaluator: {S} trajectories x {T} points vs {G} segment slots, "
        f"no obstacles, one K1 launch; best {int(res.best_index)} cost "
        f"{float(res.cost):.6f}; {EVAL_CPU_ROWS} rows agree with the CPU "
        f"(max rel {float(((got - cpu) / cpu).abs().max()):.3g})")


def turn_rate_cost(vel_traj, px, py, active_points):
    """A custom cost: the first command's turn rate (favours straight
    motion); the same value on every device."""
    import torch

    return torch.abs(vel_traj[..., 0, 2])


def _commands(dwa):
    return [float(v[0]) for v in (dwa.linear_x_control, dwa.angular_control)]


def phase_box_dwa(kernels, device):
    """A BOX robot's DWA with a custom cost on cuda, in lockstep with the
    same controller on the CPU, then one debug velocity search on both."""
    robot = make_robot(box=True)
    dwas = [make_dwa(robot, dev) for dev in (device, "cpu")]
    for dwa in dwas:
        dwa.add_custom_cost(BOX_COST_WEIGHT, turn_rate_cost)
    custom = ((BOX_COST_WEIGHT, turn_rate_cost),)
    circles = obstacle_circles()
    ties, k9 = [], 0
    for i in range(BOX_TICKS):
        scan = cast_scan(robot.state, circles)
        before = kernels.launch_counts()
        ok = [dwa.loop_step(current_state=robot.state, laser_scan=scan)
              for dwa in dwas]
        assert ok == [True, True], f"box tick {i}: {ok}"
        made = _launches_made(kernels, before)
        assert made == _solves({"K1": 1, "K9": 1}, 1), f"box tick {i}: launches {made}"
        k9 += made["K9"]
        spec, buf, out = dwas[0].last_solver_io
        assert spec.collision_box == (BOX_PARAMS[0] / 2, BOX_PARAMS[1] / 2)
        gpu, cpu = dwas
        assert gpu.has_result() and cpu.has_result(), f"box tick {i}: not found"
        assert math.isclose(gpu.result_cost, cpu.result_cost, rel_tol=COST_REL)
        if _commands(gpu) != _commands(cpu):
            _cpu_check(spec, buf, out, ties, custom)
            assert ties, f"box tick {i}: commands differ without a tie"
        apply_first_command(robot, gpu)
    vel = (robot.state.vx, robot.state.vy, robot.state.omega)
    scan = cast_scan(robot.state, circles)
    debug = [[np.asarray(a) for a in dwa.debug_velocity_search(vel, laser_scan=scan)]
             for dwa in dwas]
    (gx, gy, gc, ga), (cx, cy, cc, ca) = debug
    assert gx.shape == (SAMPLES * SAMPLES, HORIZON) and gc.shape == (SAMPLES * SAMPLES,)
    assert np.array_equal(ga, ca), "debug admissibility differs from the CPU"
    assert np.array_equal(np.isfinite(gc), ga), "debug costs vs admissibility"
    np.testing.assert_allclose(gc[ga], cc[ca], rtol=COST_REL)
    np.testing.assert_allclose(gx, cx, atol=1e-4)
    np.testing.assert_allclose(gy, cy, atol=1e-4)
    log(f"BOX DWA ({BOX_PARAMS[0]} x {BOX_PARAMS[1]} m) with a custom cost: "
        f"{BOX_TICKS} ticks on cuda in lockstep with the CPU, one K1 and one K9 "
        f"launch each, ties {ties}; debug_velocity_search: {int(ga.sum())} of "
        f"{ga.size} samples admissible on both devices")
    return k9


def phase_solver_times(kernels, device, card):
    """The fleet solver per backend and the cost evaluator (K4's own
    times are phase_static_times')."""
    import torch

    from kompass_core_tpu_torch.ops.solver import get_cost_evaluator
    from kompass_core_tpu_torch.parallel import make_fleet_solver

    for backend in SOLVER_BACKENDS:
        spec = baseline_spec(backend)
        solve = make_fleet_solver(spec, device)
        inputs = [torch.from_numpy(v).to(device)
                  for v in baseline_batches(spec, 3 + SOLVER_TIMED, seed=2)]
        lat = []
        for v in inputs[:3]:
            solve(v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in inputs[3:]:
            solve(v)
        torch.cuda.synchronize()
        chained = (time.perf_counter() - t0) * 1e3 / SOLVER_TIMED
        for v in inputs[3:]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            solve(v)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
        p50, p99 = _percentiles(lat)
        log(f"fleet solver ({backend}), {SOLVER_ROBOTS} BASELINE scenarios per call, "
            f"device-resident distinct inputs ({card}): chained over {SOLVER_TIMED} "
            f"calls {chained:.4f} ms per call, {SOLVER_ROBOTS * 1e3 / chained:.1f} "
            f"solves/s; one call with sync median {p50:.4f} ms, p99 {p99:.4f} ms")

    params, args = evaluator_inputs(device, *EVAL_SHAPE[:2])
    dev_args = [torch.from_numpy(np.asarray(a)).to(device) for a in args]
    ev = get_cost_evaluator(device, with_obstacles=False)
    ref_lens = [torch.tensor(10.0 + 1e-4 * k, device=device)
                for k in range(2 + EVAL_TIMED)]
    for rtl in ref_lens[:2]:
        ev(params, *dev_args[:10], rtl, dev_args[11])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for rtl in ref_lens[2:]:
        ev(params, *dev_args[:10], rtl, dev_args[11])
    stop.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / EVAL_TIMED
    S, T, G = EVAL_SHAPE
    log(f"cost evaluator, {S} trajectories x {T} points, {G} segment slots ({card}): "
        f"{start.elapsed_time(stop) / EVAL_TIMED:.4f} ms per call by CUDA events, "
        f"{host:.4f} ms by the host clock, over {EVAL_TIMED} distinct inputs")


# --- this slice: the TPU kernels' own forms (K6, K7, K8) and the k-tick loop ---


def _form_call(kernels, wrapper, moving, case, ap, plain=False):
    """One sweep of ``wrapper`` (or its plain version) on a _moving_case."""
    px, py, obs, vel, dt, sx, sy = case
    fn = getattr(kernels, wrapper + ("_reference" if plain else ""))
    if moving:
        return fn(px, py, obs, vel, dt, sx, sy, ap)
    return fn(px, py, obs, sx, sy, ap)


def phase_tpu_forms_vs_plain(kernels, device):
    """K6, K7 and K8 against their plain versions on the same card
    tensors, bit for bit, at the k-tick loop's shapes and edge cases; K8
    at zero velocity against K6, K7 against K2 (within the expanded
    tolerance: another summation order), and their segment fields
    against K2's and K6's; K6 also on the static kernel's edge cases at
    each samples per thread."""
    import torch

    gen = torch.Generator().manual_seed(8)
    B, S, T, O, G = FLEET_SHAPE
    cases = [(f"path shapes B={B}, {S}x{T} vs {O}+{G} rows",
              _moving_case(gen, device, B, S, T, O, G), None)]
    case = _moving_case(gen, device, 2, S, T, O, G)
    case[2][:, O - 120:], case[3][:, O - 120:] = 1e8, 0.0
    cases.append(("120 pad rows (1e8, zero velocity), B=2", case, T))
    cases.append(("O=700, G=333 (ragged tiles)",
                  _moving_case(gen, device, 1, S, T, 700, 333), T))
    cases.append(("O=1100, G=1025 (rows past one tile), B=2",
                  _moving_case(gen, device, 2, S, T, 1100, 1025), T))
    cases.append(("S=1025 (samples past one block), B=2",
                  _moving_case(gen, device, 2, 1025, T, O, G), 17))
    cases.append(("T=1, B=3", _moving_case(gen, device, 3, S, 1, O, G), 1))
    cases.append(("S*T=259 (ragged block), B=3",
                  _moving_case(gen, device, 3, 37, 7, 512, G), 5))
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, 3, 300, T, 1100, G)
    cases.append(("NaN and +-inf points, rows and velocities (robots 0 and 2)",
                  (*_non_finite(px, py, obs, vel, sx, sy)[:4], dt, sx, sy), T))
    errs = {}
    for key, wrapper, moving in TPU_FORMS:
        errs[key] = 0.0
        for name, case, active in cases:
            robots = case[0].shape[0]
            if active is None:
                ap = torch.randint(2, T + 1, (robots,), generator=gen,
                                   dtype=torch.int32).to(device)
            else:
                ap = torch.full((robots,), active, dtype=torch.int32, device=device)
            got = _form_call(kernels, wrapper, moving, case, ap)
            want = _form_call(kernels, wrapper, moving, case, ap, plain=True)
            torch.cuda.synchronize()
            if name.startswith("NaN"):
                for g, w in zip(got, want):
                    assert torch.equal(g.isnan(), w.isnan()), f"{key} {name}: NaN"
                    assert torch.equal(g.nan_to_num(), w.nan_to_num()), f"{key} {name}"
                assert bool(got[0][0].isnan().any()) and not bool(got[0][1].isnan().any())
                assert bool(got[0][2].isnan().all()), f"{key} {name}: a NaN row dropped"
            else:
                errs[key] = max(errs[key], _check_equal(f"{key} {name}", got, want,
                                                        active))
            log(f"{key} ({wrapper}) == plain: {name}")
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, B, S, T, O, G)
    ap = torch.randint(2, T + 1, (B,), generator=gen, dtype=torch.int32).to(device)
    zero = torch.zeros_like(vel)
    k6 = kernels.fused_min_dist_sq_broadcast(px, py, obs, sx, sy, ap)
    k8z = kernels.fused_min_dist_sq_moving_broadcast(px, py, obs, zero, dt, sx, sy, ap)
    k2 = kernels.fused_min_dist_sq_expanded(px, py, obs, sx, sy, ap)
    k7z = kernels.fused_min_dist_sq_moving_expanded(px, py, obs, zero, dt, sx, sy, ap)
    k7 = kernels.fused_min_dist_sq_moving_expanded(px, py, obs, vel, dt, sx, sy, ap)
    k8 = kernels.fused_min_dist_sq_moving_broadcast(px, py, obs, vel, dt, sx, sy, ap)
    torch.cuda.synchronize()
    _check_equal("K8 at zero velocity vs K6", k8z, k6)
    finite = torch.isfinite(k2[0])
    torch.testing.assert_close(k7z[0][finite], k2[0][finite], rtol=2e-4, atol=1e-4)
    k7_vs_k2 = float((k7z[0][finite] - k2[0][finite]).abs().max())
    assert torch.equal(k7[1], k2[1]) and torch.equal(k8[1], k6[1]), "segment fields"
    log(f"at the path shapes: K8 at zero velocity == K6; K7 at zero velocity vs "
        f"K2 max abs {k7_vs_k2:.3g} m^2 (rel 2e-4 / atol 1e-4); K7's segment field "
        f"== K2's, K8's == K6's")
    errs["K6"] = max(errs["K6"], _static_vs_plain(kernels, "fused_min_dist_sq_broadcast",
                                                  device, 16))
    return errs


def _ticks_eager(fleet, k, device):
    """The fleet's k-tick loop run eagerly on its device from its packed
    inputs and a copy of its carry: (carry', outs [N, k, F], final)."""
    import torch

    from kompass_core_tpu_torch.ops.fleet_solver import FleetCarry

    carry = FleetCarry(*(t.clone() for t in fleet._carry))
    inputs = torch.tensor(fleet._inputs, device=device)
    # chip_ab.py's turns also time trees whose fleet has no safety gate
    safety = getattr(fleet, "_safety", None)
    return fleet.ticks_fn(k)(fleet._paths, fleet._cfg, carry, fleet._angles, inputs,
                             *(() if safety is None else (safety,)))


def _replay_calls(kernels, fleet, drive, device, keys, label, each=None):
    """TICKS_CALLS closed-loop calls of ``run_ticks_on_device`` (one graph
    per k), each replay equal to the eager loop bit for bit and launching
    the kernels of ``keys`` k times; ``each(out)`` sees every call's
    outputs. Returns the launches per kernel and the last call's outputs.

    The wrappers count Python calls: the first call runs the loop once on
    a side stream (the warm-up, k launches) and once under capture (k
    calls, recorded and not run), and a replay calls no wrapper. So the
    card ran the warm-up's k launches and k per replay, the first call's
    replay included: the counted 2k plus k for each later call."""
    import torch

    from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS

    counted = {}
    for call in range(TICKS_CALLS):
        inputs = drive.inputs()
        fleet._prepare_tick_inputs(*inputs)
        carry, outs, final = _ticks_eager(fleet, TICKS_K, device)
        before = kernels.launch_counts()
        out = fleet.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])
        made = _launches_made(kernels, before)
        assert made == (_solves({k: 2 * TICKS_K for k in keys}, 2 * TICKS_K)
                        if call == 0 else {}), (
            f"{label} call {call}: wrapper calls {made}")
        for k, n in made.items():
            counted[k] = counted.get(k, 0) + n
        for i, name in enumerate(OUT_FIELDS):
            want = outs[:FLEET_ROBOTS, :, i].cpu().numpy()
            assert np.array_equal(out[name].astype(np.float32), want), (
                f"{label} call {call}: {name} replay != eager")
        assert np.array_equal(out["final_states"], final[:FLEET_ROBOTS].cpu().numpy())
        assert all(torch.equal(a, b) for a, b in zip(fleet._carry, carry))
        _assert_finite(out, f"{label} call {call}")
        if each is not None:
            each(out)
        drive.advance_ticks(out, TICKS_K)
    # one k-tick graph; a fleet that also ticked holds the tick's, under None
    assert [k for k in fleet.tick_graphs if k is not None] == [TICKS_K], "one graph per k"
    return {k: n + (TICKS_CALLS - 1) * (n // 2) for k, n in counted.items()}, out


def phase_ticks(kernels, device):
    """The k-tick loop at full width, per backend: the eager loop on the
    card, then ``DeviceFleet.run_ticks_on_device`` (one captured CUDA
    graph, replayed) bit for bit against it, TICKS_CALLS closed-loop
    calls (``_replay_calls``). Returns each form's kernel launches by the
    ``run_ticks_on_device`` calls alone (not by the eager reference)."""
    import torch

    launches = {}
    for backend, tracked, key in TICKS_FORMS:
        fleet, lanes, circles = make_fleet(device, tracked, backend=backend)
        drive = FleetDrive(lanes, circles, tracked)
        ends = np.stack([p[-1] for p in fleet_scene()[1]])
        start = drive.goal_distance(ends)
        found = []

        def each(out):
            for name, col in out.items():
                assert np.isfinite(col).all(), f"{backend}/{tracked}: {name}"
            found.append(int(out["found"].sum()))

        made, _ = _replay_calls(kernels, fleet, drive, device, (key,),
                                f"{backend}/{tracked}", each)
        for k, n in made.items():  # summed: every form launches K10
            launches[k] = launches.get(k, 0) + n
        end = drive.goal_distance(ends)
        ticks = TICKS_CALLS * TICKS_K
        log(f"k-tick loop ({backend}, {tracked} tracked slots): {TICKS_CALLS} calls "
            f"of k={TICKS_K} on {FLEET_ROBOTS} robots, graph replay == eager loop bit "
            f"for bit; {key} {TICKS_K} per replay; found {sum(found)}/"
            f"{FLEET_ROBOTS * ticks}; mean goal distance {start.mean():.3f} -> "
            f"{end.mean():.3f} m")
        assert sum(found) >= 0.9 * FLEET_ROBOTS * ticks, f"{backend}: the fleet lost its way"
        assert end.mean() < start.mean() - 0.5, f"{backend}: no approach to the goals"
        del fleet
    torch.cuda.empty_cache()
    return launches


def phase_ticks_cpu(device):
    """A few robots' k-tick loop on the card against the same loop on the
    CPU: per robot, ticks agree at the fleet phase's tolerance up to and
    including its first tie (after a tie each device integrates its own
    winner)."""
    n = TICKS_CPU_ROBOTS
    fleets = [make_fleet(dev, FLEET_TRACKED, robots=n) for dev in (device, "cpu")]
    lanes, circles = fleets[0][1], fleets[0][2]
    drive = FleetDrive(lanes, circles, FLEET_TRACKED)
    compared, ties = 0, []
    inputs = drive.inputs()
    gpu, cpu = (f.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])
                for f, _, _ in fleets)
    for r in range(n):
        for i in range(TICKS_K):
            for key in ("num_admissible", "active_points", "reached", "found"):
                assert gpu[key][r, i] == cpu[key][r, i], f"robot {r} tick {i}: {key}"
            assert math.isclose(gpu["cost"][r, i], cpu["cost"][r, i], rel_tol=COST_REL,
                                abs_tol=1e-6), f"robot {r} tick {i}: cost"
            compared += 1
            cmd = [gpu[k][r, i] for k in ("vx", "vy", "omega")]
            if cmd != [cpu[k][r, i] for k in ("vx", "vy", "omega")]:
                assert abs(gpu["cost"][r, i] - cpu["cost"][r, i]) <= (
                    TIE_REL * abs(cpu["cost"][r, i])), f"robot {r} tick {i}: not a tie"
                ties.append((r, i))
                break
        else:
            np.testing.assert_allclose(gpu["final_states"][r], cpu["final_states"][r],
                                       rtol=1e-5, atol=1e-5)
    log(f"k-tick loop, {n} robots x k={TICKS_K} (xla, {FLEET_TRACKED} tracked slots): "
        f"card == CPU on {compared} robot-ticks; ties {ties}")


def _median_ms(fn, repeats):
    import torch

    lat = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(lat), min(lat), max(lat)


def phase_ticks_times(device, card):
    """Per-tick time of the replayed k-tick graph (the whole call:
    host input packing, one copy in, the replay, one copy out) and of k
    eager ticks on the card (the same loop enqueued op by op), host clock
    with syncs, median of TICKS_TIMED calls; and the replay alone by
    CUDA events, back to back."""
    import torch

    for backend, tracked, key in TICKS_FORMS:
        fleet, lanes, circles = make_fleet(device, tracked, backend=backend)
        drive = FleetDrive(lanes, circles, tracked)
        inputs = drive.inputs()
        fleet.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])  # capture
        graph = _median_ms(lambda: fleet.run_ticks_on_device(
            TICKS_K, *inputs[:4], tracked=inputs[4]), TICKS_TIMED)
        fleet._prepare_tick_inputs(*inputs)
        _ticks_eager(fleet, TICKS_K, device)
        eager = _median_ms(lambda: _ticks_eager(fleet, TICKS_K, device), TICKS_TIMED)
        replay = fleet.tick_graphs[TICKS_K].graph.replay
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TICKS_TIMED):
            replay()
        stop.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(stop) / TICKS_TIMED
        log(f"k-tick loop ({backend}, {tracked} tracked slots, {key}), {FLEET_ROBOTS} "
            f"robots, k={TICKS_K} ({card}): graph replay {graph[0] / TICKS_K:.4f} ms "
            f"per tick (call median {graph[0]:.4f}, min {graph[1]:.4f}, max "
            f"{graph[2]:.4f} ms; the replay alone {device_ms:.4f} ms by CUDA events, "
            f"{device_ms / graph[0]:.1%} of the call); eager loop "
            f"{eager[0] / TICKS_K:.4f} ms per tick (call median {eager[0]:.4f}, min "
            f"{eager[1]:.4f}, max {eager[2]:.4f} ms)")
        del fleet


# (pair, segment pair, per-step row) FP32 instructions of each form:
# K6 2 FMUL + 2 FADD + min per pair; K7 4 FFMA + min, its segment pair
# K2's 6, its prefix 2 FFMA; K8 4 FMUL + 4 FADD + min, its segment pair
# K6's 5, its prefix 2 FMUL + 2 FADD
FORM_OPS = {"K6": (5, 5, 0), "K7": (5, 6, 2), "K8": (9, 5, 4)}


def phase_tpu_forms_times(kernels, device, card):
    """K6, K7 and K8 against their plain versions at the path shapes, in
    turns, over TPU_FORM_INPUTS distinct inputs."""
    import torch

    B, S, T, O, G = FLEET_SHAPE
    gen = torch.Generator().manual_seed(9)
    results = {}
    for key, wrapper, moving in TPU_FORMS:
        ap = torch.full((B,), T, dtype=torch.int32, device=device)
        cases = [_moving_case(gen, device, B, S, T, O, G) for _ in range(TPU_FORM_INPUTS)]
        inputs = [((px, py, obs, vel, dt, sx, sy, ap) if moving else
                   (px, py, obs, sx, sy, ap)) for px, py, obs, vel, dt, sx, sy in cases]
        k_ms, p_ms, runs = _in_turns(getattr(kernels, wrapper),
                                     getattr(kernels, wrapper + "_reference"), inputs,
                                     warm=1)
        b_ms, b_by = form_bound(cases[0][0], O, ap, G, *FORM_OPS[key], moving=moving)
        log(f"{wrapper} ({key}) at B={B}, {S}x{T} vs {O}+{G} rows ({card}), CUDA "
            f"events over {TPU_FORM_INPUTS} distinct inputs, in turns {runs}: kernel "
            f"{k_ms:.5f} ms, plain {p_ms:.5f} ms; bound {b_ms:.5f} ms ({b_by}), "
            f"{b_ms / k_ms:.1%} of it")
        results[key] = (k_ms, p_ms, b_ms, b_by)
        del cases, inputs
    return results


# --- this slice: the emergency stop and fleet peer avoidance (5c, 5d) --------

# EmergencyChecker cases per zone configuration, each checked both ways
CHECKER_SCANS = 8
CHECKER_CLOUDS = 2
# the peer fleet: the fleet slice's 64 robots with peers (the center and 8
# ring points of every robot), prediction, 8 tracked slots and the safety
# gate at FleetSafetyConfig()'s reference defaults (160 deg, 0.3, 0.6 m)
PEER_RING = 8
PEER_ROWS = FLEET_SHAPE[3] + FLEET_ROBOTS * (PEER_RING + 1)  # 768 + 576 = 1344
PEER_SHAPE = (FLEET_ROBOTS, 2025, 30, PEER_ROWS, 384)
PEER_FORMS = (("xla", "K3"), ("pallas", "K7"), ("pallas_vpu", "K8"))
PEER_TICKS = 30
PEER_STATIC_TICKS = 3  # peers without prediction: the static sweep, K1
PEER_CPU_TICKS = (0, 29)
PEER_CPU_ROBOTS = (0, 22, 43, 63)
PEER_RADIUS = 0.25
GROUP_SPACING = 25.0
WALL_GAP = 1.0  # the wall robots' start, center to wall, in the tick phase
TICKS_WALL_GAP = 0.75  # ... and in the k-tick phase, at TICKS_WALL_SPEED
TICKS_WALL_SPEED = 0.6
# the sweeps at the peer width: (name, wrapper, moving, PERF.md name)
PEER_SWEEPS = (("K1", "fused_min_dist_sq", False), ("K3", "fused_min_dist_sq_moving", True),
               ("K6", "fused_min_dist_sq_broadcast", False),
               ("K7", "fused_min_dist_sq_moving_expanded", True),
               ("K8", "fused_min_dist_sq_moving_broadcast", True))
PEER_SWEEP_INPUTS = 2  # distinct inputs per timed run (K7's plain: ~3 s each)


def phase_emergency(device):
    """``EmergencyChecker`` on the card against the CPU, bit for bit:
    512-ray scans with NaN and inf returns, beams exactly at the critical
    and at the slowdown distance, clouds of 100k points; a centered
    sensor, a translated and rotated one, and the 360-degree cone (which
    the reference wraps to empty cones); both directions each. A cloud
    point within an ulp of a bin edge may bin differently on the card
    (atan2), so a cloud factor that differs must come from different
    binned ranges: the CPU's check of the card's ranges gives the card's
    factor."""
    import torch

    from kompass_core_tpu_torch.datatypes import LaserScanData, PointCloudData
    from kompass_core_tpu_torch.ops.critical_zone import critical_zone_check
    from kompass_core_tpu_torch.ops.mapping import pointcloud_to_scan, pad_cloud_to_bucket
    from kompass_core_tpu_torch.utils.emergency_stop import EmergencyChecker

    robot = make_robot()
    radius = float(robot.geometry_params[0])
    zones = (("centered", 160.0, {}),
             ("translated and rotated sensor", 160.0,
              dict(sensor_position_robot=[0.12, -0.05, 0.3],
                   sensor_rotation_robot=[0.0, 0.0, math.sin(0.2), math.cos(0.2)])),
             ("360-degree cone", 360.0, {}))
    rng = np.random.default_rng(21)
    angles = np.linspace(-np.pi, np.pi, RAYS, endpoint=False)
    factors, explained = [], 0
    for name, cone, kw in zones:
        checkers = [EmergencyChecker(robot, 0.3, 0.6, cone, device=d, **kw)
                    for d in (device, "cpu")]
        for case in range(CHECKER_SCANS):
            ranges = rng.uniform(0.4, 3.0, RAYS)
            ranges[rng.random(RAYS) < 0.05] = np.nan
            ranges[rng.integers(RAYS)] = np.inf
            if case % 4 == 1:  # beams at the critical distance
                ranges[::7] = np.float32(radius + 0.3)
            elif case % 4 == 2:  # ... and at the slowdown distance
                ranges = np.where(np.isfinite(ranges), np.maximum(ranges, 0.9), ranges)
                ranges[::5] = np.float32(radius + 0.6)
            elif case % 4 == 3:  # clear
                ranges = np.where(np.isfinite(ranges), ranges + 1.0, ranges)
            scan = LaserScanData(ranges=ranges, angles=angles, range_max=RANGE_MAX)
            for forward in (True, False):
                got, want = (c.run(scan=scan, forward=forward) for c in checkers)
                assert got == want, f"{name} scan {case} forward={forward}: {got} vs {want}"
                factors.append(got)
        for case in range(CHECKER_CLOUDS):
            pts = cloud_points(31 + case)
            pts[:50, 0:2] *= 0.08  # a few points inside the critical band
            cloud = PointCloudData(points=pts)
            for forward in (True, False):
                got, want = (c.run(scan=cloud, forward=forward) for c in checkers)
                if got != want:
                    spec = checkers[0]._spec
                    args = (spec.cos_angles.__len__(), np.float32(10.0),
                            np.float32(-0.4), np.float32(0.4))
                    padded = pad_cloud_to_bucket(pts)
                    card = pointcloud_to_scan(torch.from_numpy(padded).to(device), *args)
                    host = pointcloud_to_scan(torch.from_numpy(padded), *args)
                    assert not torch.equal(card.cpu(), host), f"{name} cloud {case}"
                    assert float(critical_zone_check(spec, card.cpu(), forward)) == got
                    explained += 1
                factors.append(got)
    assert 0.0 in factors and 1.0 in factors and any(0.0 < f < 1.0 for f in factors)
    log(f"emergency checker: card == CPU on {len(factors)} checks "
        f"({len(zones)} zones x ({CHECKER_SCANS} scans of {RAYS} rays + "
        f"{CHECKER_CLOUDS} clouds of {CLOUD_POINTS} points) x 2 directions; "
        f"{factors.count(0.0)} stops, {factors.count(1.0)} clear, "
        f"{sum(0.0 < f < 1.0 for f in factors)} in the band; cloud factors "
        f"explained by a bin edge: {explained})")


def _cast_walls(states, walls):
    """[N, RAYS] ranges from each robot's pose against its one wall
    segment walls [N, 4] (x1, y1, x2, y2); no hit within range gives +inf."""
    angles = np.linspace(-np.pi, np.pi, RAYS, endpoint=False)
    th = states[:, 2:3] + angles
    dx, dy = np.cos(th), np.sin(th)
    ex, ey = (walls[:, 2] - walls[:, 0])[:, None], (walls[:, 3] - walls[:, 1])[:, None]
    ax = (walls[:, 0] - states[:, 0])[:, None]
    ay = (walls[:, 1] - states[:, 1])[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = dx * ey - dy * ex
        t = (ax * ey - ay * ex) / denom
        u = (ax * dy - ay * dx) / denom
    hit = (denom != 0.0) & (t > 0.0) & (u >= 0.0) & (u <= 1.0) & (t <= RANGE_MAX)
    return np.where(hit, t, np.inf).astype(np.float32), angles


class PeerDrive:
    """The peer fleet's closed loop: 16 groups of 4 robots, 25 m apart. In
    each group a head-on pair on one line (from (0, 0) to +x and from
    (5, 0) to -x); in even groups a crossing pair (paths crossing at
    right angles at (11, 0)), in odd groups two robots driving +y at a
    wall across their paths (y = 0, 13 m wide), starting ``wall_gap``
    before it at ``wall_speed``. The last robot (a wall robot) is boxed
    in: every return 0.5 m, inside the critical band all around. Every
    robot starts 3 cm off its path and gets one live mover (slot 0 of
    8, walking 6 m to its side)."""

    def __init__(self, n, wall_gap=WALL_GAP, wall_speed=0.0, tracked=FLEET_TRACKED):
        self.tracked = tracked
        g = np.arange(n) // 4
        role = np.arange(n) % 4 + 4 * (g % 2 == 1) * (np.arange(n) % 4 >= 2)
        origin = np.stack([GROUP_SPACING * (g % 4), GROUP_SPACING * (g // 4)], 1)
        # per role: path start, path end, yaw; the robot starts 3 cm off
        # its path (roles 4 and 5: the wall robots)
        path_start = np.array([[0.0, 0.0], [5.0, 0.03], [8.5, -2.5], [8.5, 2.5],
                               [0, 0], [0, 0], [14.0, -wall_gap], [17.0, -wall_gap]])
        goal = np.array([[5.0, 0.0], [0.0, 0.03], [13.5, 2.5], [13.5, -2.5],
                         [0, 0], [0, 0], [14.0, 4.0], [17.0, 4.0]])
        off = np.array([[0.0, 0.031], [0.0, 0.031], [0.022, -0.022], [0.022, 0.022],
                        [0, 0], [0, 0], [0.031, 0.0], [0.031, 0.0]])
        self.states = np.zeros((n, 4), np.float32)
        self.states[:, 0:2] = origin + path_start[role] + off[role]
        d = goal[role] - path_start[role]
        self.states[:, 2] = np.arctan2(d[:, 1], d[:, 0])
        self.vels = np.zeros((n, 3), np.float32)
        self.wall = role >= 6
        self.states[self.wall, 3] = self.vels[self.wall, 0] = wall_speed
        self.paths = [np.stack([origin[i] + path_start[role[i]], origin[i] + goal[role[i]]])
                      for i in range(n)]
        self.walls = np.concatenate([origin + (8.0, 0.0), origin + (21.0, 0.0)], 1)
        self.walls[g % 2 == 0] = (0.0, 1e4, 1.0, 1e4)  # out of range
        self.boxed = n - 1
        self.movers = self.states[:, 0:2] + (-6.0, 0.0)
        self.mover_vel = np.array([0.0, 0.5])
        self.min_pair = self._min_pair(self.states)

    @staticmethod
    def _min_pair(states):
        d = np.hypot(states[:, None, 0] - states[None, :, 0],
                     states[:, None, 1] - states[None, :, 1])
        return float(d[~np.eye(len(states), dtype=bool)].min())

    def inputs(self):
        ranges, angles = _cast_walls(self.states, self.walls)
        ranges[self.boxed] = 0.5
        tracked = None
        if self.tracked:
            tracked = np.full((len(self.states), self.tracked, 4), np.nan, np.float32)
            tracked[:, 0, 0:2] = self.movers
            tracked[:, 0, 2:4] = self.mover_vel
        return self.states, self.vels, ranges, angles, tracked

    def _step(self, s, vx, vy, om):
        c, sn = np.cos(s[:, 2]), np.sin(s[:, 2])
        s[:, 0] += DT * (vx * c - vy * sn)
        s[:, 1] += DT * (vx * sn + vy * c)
        s[:, 2] += DT * om
        s[:, 3] = np.hypot(vx, vy)

    def advance(self, out):
        """Integrate the (not-found and safety gated) commands one step."""
        cmd = [out[k].astype(np.float32) for k in ("vx", "vy", "omega")]
        self._step(self.states, *cmd)
        self.vels = np.stack(cmd, 1)
        self.movers += DT * self.mover_vel
        self.min_pair = min(self.min_pair, self._min_pair(self.states))

    def advance_ticks(self, out, k):
        """The k-tick loop's trajectories, integrated from its commands
        (for the closest approach), then its final states."""
        s = self.states.astype(np.float64).copy()
        for t in range(k):
            self._step(s, *(out[key][:, t] for key in ("vx", "vy", "omega")))
            self.min_pair = min(self.min_pair, self._min_pair(s))
        self.states = out["final_states"].astype(np.float32).copy()
        self.vels = np.stack([out[key][:, -1] for key in ("vx", "vy", "omega")],
                             1).astype(np.float32)
        self.movers += k * DT * self.mover_vel


def _placed(device, mesh):
    """A fleet's placement arguments: its device, or its mesh."""
    return dict(device=device) if mesh is None else dict(mesh=mesh)


def make_peer_fleet(device, backend="xla", predict=True, robots=None,
                    wall_gap=WALL_GAP, wall_speed=0.0, tracked=FLEET_TRACKED,
                    box_every=0, mesh=None):
    """A DeviceFleet of PeerDrive's scene with peers (and prediction),
    ``tracked`` slots and the safety gate; ``backend`` for its tick and
    its k-tick loop; with ``box_every``, every such robot a BOX
    (FLEET_BOX_PARAMS), which makes the fleet a BOX fleet; over ``mesh``
    instead of on ``device`` when given. Returns (fleet, drive)."""
    from kompass_core_tpu_torch.control import DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu_torch.ops.fleet_solver import make_fleet_tick
    from kompass_core_tpu_torch.parallel import DeviceFleet
    from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig

    n = FLEET_ROBOTS if robots is None else robots
    robot_list = [
        Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
              geometry_type=RobotGeometry.Type.BOX,
              geometry_params=np.array(FLEET_BOX_PARAMS))
        if box_every and i % box_every == 0 else
        Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
              geometry_type=RobotGeometry.Type.CYLINDER,
              geometry_params=np.array([PEER_RADIUS, 0.4]))
        for i in range(n)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=VX_MAX, max_acc=1.5, max_decel=2.5),
        omega_limits=AngularCtrlLimits(max_vel=1.5, max_acc=3.0, max_decel=3.0),
    )
    config = DWAConfig(max_linear_samples=SAMPLES, max_angular_samples=SAMPLES,
                       prediction_horizon=HORIZON, control_horizon=CONTROL_HORIZON,
                       control_time_step=DT)
    fleet = DeviceFleet(robot_list, limits, config, RAYS, tracked_obstacles=tracked,
                        peer_avoidance=True, peer_ring_points=PEER_RING,
                        peer_prediction=predict, safety_config=FleetSafetyConfig(),
                        **_placed(device, mesh))
    if backend != "xla":
        fleet.spec = dataclasses.replace(fleet.spec, solver=dataclasses.replace(
            fleet.spec.solver, backend=backend))
        fleet._tick_fn = make_fleet_tick(fleet.spec, **_placed(device, mesh),
                                         peer_cfg=fleet._peer_cfg, safety=True)
    drive = PeerDrive(n, wall_gap, wall_speed, tracked)
    fleet.set_paths(drive.paths)
    solver = fleet.spec.solver
    assert (fleet._n, solver.num_samples, solver.max_points, solver.seg_size) == (
        n, *PEER_SHAPE[1:3], PEER_SHAPE[4])
    assert solver.scan_size == FLEET_SHAPE[3] or not tracked
    return fleet, drive


def _peer_cpu_check(fleet, carry_before, out, tick, ties):
    """The sampled robots' rows against the port's step on the CPU, fed
    the same inputs, path, config, carry and safety rows and the peer
    rows the whole fleet's states give (every operation after the peer
    set is row-local)."""
    import torch

    from kompass_core_tpu_torch.ops.fleet_solver import (
        FleetCarry, FleetConfig, FleetPaths, FleetSafety, _fleet_step, _peer_model,
        _split_tick_inputs,
    )

    spec = fleet.spec.solver
    idx = torch.tensor(PEER_CPU_ROBOTS)
    inputs = torch.from_numpy(fleet._inputs.copy())
    states, vels, ranges, tracked = _split_tick_inputs(fleet.spec, inputs)
    rows, vel, count = _peer_model(spec, fleet._peer_cfg, "cpu")(inputs[:, 0:7])
    _, cpu = _fleet_step(
        spec, FleetPaths(*(t.cpu()[idx] for t in fleet._paths)),
        FleetConfig(*(t.cpu()[idx] for t in fleet._cfg)),
        FleetCarry(*(t[idx] for t in carry_before)), states[idx], vels[idx],
        ranges[idx], fleet._angles.cpu()[idx], spec.seg_size, tracked[idx],
        peers=(rows[idx], None if vel is None else vel[idx], count),
        safety=FleetSafety(*(t.cpu()[idx] for t in fleet._safety)),
    )
    _compare_cpu_rows(out, cpu, PEER_CPU_ROBOTS, tick, ties, exact=("safety_factor",))


def _assert_finite(out, where):
    """Every output column finite, but the cost of a robot that found no
    admissible sample (+inf: the boxed robot may find none)."""
    for name, col in out.items():
        ok = np.isfinite(col)
        if name == "cost":
            ok |= ~out["found"]
        assert ok.all(), f"{where}: {name}"


def _launches_made(kernels, before):
    return {n: c - before[n] for n, c in kernels.launch_counts().items() if c != before[n]}


def _solves(expect, n):
    """The launches ``expect`` plus K10, the goal cost's search, which each
    of ``n`` solves launches once."""
    return {**expect, "K10": n}


def _card_runs(made, graphs):
    """The launches the card ran, from the wrapper calls ``made`` of calls
    that captured ``graphs`` (``DeviceFleet``'s TickGraphs) and replayed
    them: a capture calls each wrapper twice, for the warm-up, which runs,
    and for the recording, which does not; a replay calls none and runs
    the graph's ``launches``. So each graph adds its launches times its
    replays less one."""
    runs = dict(made)
    for g in graphs:
        for key, n in g.launches.items():
            runs[key] = runs.get(key, 0) + n * (g.replays - 1)
    return runs


@contextlib.contextmanager
def _fleet_graphs():
    """Every TickGraph a ``DeviceFleet`` captures inside the block, in the
    list it yields."""
    from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet

    graphs, capture = [], DeviceFleet._capture

    def recorded(self, *args):
        graphs.append(capture(self, *args))
        return graphs[-1]

    DeviceFleet._capture = recorded
    try:
        yield graphs
    finally:
        DeviceFleet._capture = capture


def _tick_checked(kernels, fleet, tick, expect, call, shards=1):
    """``call()``, the ``tick``-th ``DeviceFleet.tick`` of ``fleet`` (from
    its first), each of whose ``shards`` shards launches ``expect`` (and
    K10) a tick. A graphed fleet's first tick captures a graph a shard,
    calling each wrapper twice (the warm-up and the recording), and its
    later ticks replay them, calling none; each graph records ``expect``
    and has replayed once a tick. An eager fleet calls the wrappers every
    tick. Returns what ``call`` returned."""
    expect = _solves(expect, 1)
    before = kernels.launch_counts()
    out = call()
    made = _launches_made(kernels, before)
    if fleet._graphed():
        want = {k: 2 * shards * n for k, n in expect.items()} if tick == 0 else {}
        graphs = fleet.tick_graphs[None]
        graphs = graphs if isinstance(graphs, list) else [graphs]
        assert len(graphs) == shards and all(
            g.launches == expect and g.replays == tick + 1 for g in graphs), (
            f"tick {tick}: graphs {[(g.launches, g.replays) for g in graphs]}")
    else:
        want = {k: shards * n for k, n in expect.items()}
    assert made == want, f"tick {tick}: wrapper calls {made}, expected {want}"
    return out


def _zero_launches(kernels):
    """Every kernel wrapper's launch count back to 0."""
    for counter in (*kernels.SWEEP_KERNELS.values(), kernels.scan_to_grid_cells,
                    kernels.goal_nearest):
        counter.launches = 0


def phase_peers(kernels, device):
    """Peers, prediction and safety at full width: the 64-robot peer
    fleet for PEER_TICKS closed-loop single ticks per backend (xla: K3,
    pallas: K7, pallas_vpu: K8). Every tick launches its kernel once and
    no host sync; at PEER_CPU_TICKS the rows of PEER_CPU_ROBOTS agree
    with the CPU; wall robots are slowed (factor < 1), the boxed robot
    is stopped (factor 0, zero command) on every tick, and no two robots
    come closer than the sum of their radii. Then a peer fleet without
    prediction and tracked slots launches the static sweep K1 once per
    tick. Each fleet's tick is one CUDA graph (``_tick_checked``; the sync
    guard wraps the tick program for its warm-up and capture). Returns
    the launches per kernel that the card ran (each graph's warm-up and
    replays) and the wrapper calls."""
    import torch

    launches = {}
    start = kernels.launch_counts()
    for backend, key in PEER_FORMS:
        fleet, drive = make_peer_fleet(device, backend)
        fleet._tick_fn = sync_guarded(fleet._tick_fn)
        ties, wall_min, found = [], 1.0, 0
        for tick in range(PEER_TICKS):
            carry = [t.cpu() for t in fleet._carry]
            out = _tick_checked(kernels, fleet, tick, {key: 1}, lambda: fleet.tick(
                *drive.inputs()[:4], tracked=drive.inputs()[4]))
            _assert_finite(out, f"{backend} tick {tick}")
            if tick in PEER_CPU_TICKS:
                _peer_cpu_check(fleet, carry, out, tick, ties)
            b = drive.boxed
            assert out["safety_factor"][b] == 0.0, f"tick {tick}: boxed robot not stopped"
            assert out["vx"][b] == out["vy"][b] == out["omega"][b] == 0.0
            wall_min = min(wall_min, float(out["safety_factor"][drive.wall][:-1].min()))
            found += int(out["found"].sum())
            drive.advance(out)
        runs = PEER_TICKS + fleet._graphed()  # the capture's warm-up ran too
        launches[key] = runs
        launches["K10"] = launches.get("K10", 0) + runs
        torch.cuda.synchronize()
        log(f"peers + prediction + safety ({backend}, {key}): {FLEET_ROBOTS} robots x "
            f"{PEER_TICKS} ticks, {PEER_ROWS} + {PEER_SHAPE[4]} rows per sweep; "
            f"sync-checked tick program calls {fleet._tick_fn.calls}; found {found}/"
            f"{FLEET_ROBOTS * PEER_TICKS}; closest pair {drive.min_pair:.3f} m "
            f"(radii sum {2 * PEER_RADIUS}); wall robots' min safety factor "
            f"{wall_min:.4f}; boxed robot stopped every tick; CPU-checked rows "
            f"{len(PEER_CPU_TICKS) * len(PEER_CPU_ROBOTS)}, ties {ties}")
        assert fleet._tick_fn.calls == (2 if fleet._graphed() else PEER_TICKS)
        assert drive.min_pair > 2 * PEER_RADIUS, f"{backend}: robots collided"
        assert wall_min < 1.0, f"{backend}: no wall robot was slowed"
        del fleet
    fleet, drive = make_peer_fleet(device, "xla", predict=False, tracked=0)
    for tick in range(PEER_STATIC_TICKS):
        out = _tick_checked(kernels, fleet, tick, {"K1": 1}, lambda: fleet.tick(
            *drive.inputs()[:4], tracked=drive.inputs()[4]))
        drive.advance(out)
    runs = PEER_STATIC_TICKS + fleet._graphed()
    launches["K1"] = runs
    launches["K10"] += runs
    log(f"peers without prediction or tracked slots: {PEER_STATIC_TICKS} ticks, one "
        f"static sweep (K1) each; closest pair {drive.min_pair:.3f} m")
    torch.cuda.empty_cache()
    return launches, _launches_made(kernels, start)


def phase_peer_ticks(kernels, device):
    """The k = 8 loop with peers, prediction and safety per backend:
    TICKS_CALLS closed-loop calls of ``run_ticks_on_device`` (one graph
    per k), each replay equal to the eager loop bit for bit
    (``_replay_calls``); the wall robots start TICKS_WALL_GAP from their
    wall at TICKS_WALL_SPEED and are slowed (factor below 1) and then
    stopped (command below 0.05 m/s) inside the loop; no two robots come
    closer than the sum of their radii. Returns the launches per kernel,
    counted as ``phase_ticks`` counts them."""
    import torch

    launches = {}
    for backend, key in PEER_FORMS:
        fleet, drive = make_peer_fleet(device, backend, wall_gap=TICKS_WALL_GAP,
                                       wall_speed=TICKS_WALL_SPEED)
        factors = []
        made, out = _replay_calls(kernels, fleet, drive, device, (key,), backend,
                                  lambda out: factors.append(
                                      out["safety_factor"][drive.wall]))
        for k, n in made.items():  # summed: every form launches K10
            launches[k] = launches.get(k, 0) + n
        last_vx = np.abs(out["vx"][drive.wall, -1])
        log(f"k-tick loop with peers + prediction + safety ({backend}, {key}): "
            f"{TICKS_CALLS} calls of k={TICKS_K}, graph replay == eager loop bit for "
            f"bit; closest pair {drive.min_pair:.3f} m; the first wall robot's safety factor "
            f"per tick {np.concatenate([f[0] for f in factors]).round(4).tolist()}; "
            f"their last |vx| max {last_vx.max():.4f} m/s")
        assert any(bool((f < 1.0).any()) for f in factors), (
            f"{backend}: no wall robot slowed inside the loop")
        assert last_vx.max() < 0.05, f"{backend}: a wall robot did not stop"
        assert drive.min_pair > 2 * PEER_RADIUS, f"{backend}: robots collided"
        del fleet
    torch.cuda.empty_cache()
    return launches


def _peer_width_case(gen, device, moving):
    """A sweep's inputs at the peer width: 64 robots x 2025 x 30 points
    against the scan bucket (768 rows) and 576 peer rows, each robot's
    own 9 at the 1e8 pad with zero velocity, + 384 segment rows."""
    B, S, T, O, G = PEER_SHAPE
    px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, B, S, T, O, G)
    block = PEER_RING + 1
    for b in range(B):
        own = slice(FLEET_SHAPE[3] + b * block, FLEET_SHAPE[3] + (b + 1) * block)
        obs[b, own], vel[b, own] = 1e8, 0.0
    return (px, py, obs, vel, dt, sx, sy) if moving else (px, py, obs, sx, sy)


def _sweep_args(case, ap, moving):
    if moving:
        px, py, obs, vel, dt, sx, sy = case
        return px, py, obs, vel, dt, sx, sy, ap
    px, py, obs, sx, sy = case
    return px, py, obs, sx, sy, ap


def _plain_sweep(kernels, key, wrapper):
    """The plain version of a sweep wrapper, with the wrapper's arguments."""
    if key != "K3":
        return getattr(kernels, wrapper + "_reference")

    def plain(px, py, obs, vel, dt, sx, sy, ap):
        return kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap, vel, dt)

    return plain


def phase_peer_sweeps_vs_plain(kernels, device):
    """K1, K3, K6, K7 and K8 against their plain versions at the peer
    width, bit for bit, with mixed active steps. Returns each one's max
    abs difference."""
    import torch

    gen = torch.Generator().manual_seed(13)
    B, S, T, O, G = PEER_SHAPE
    errs = {}
    for key, wrapper, moving in PEER_SWEEPS:
        case = _peer_width_case(gen, device, moving)
        ap = torch.randint(2, T + 1, (B,), generator=gen, dtype=torch.int32).to(device)
        args = _sweep_args(case, ap, moving)
        got = getattr(kernels, wrapper)(*args)
        want = _plain_sweep(kernels, key, wrapper)(*args)
        torch.cuda.synchronize()
        errs[key] = _check_equal(f"{key} at the peer width", got, want)
        log(f"{key} ({wrapper}) == plain at the peer width: B={B}, {S}x{T} vs {O}+{G} rows")
        del case, args, got, want
    return errs


def phase_peer_sweep_times(kernels, device, card):
    """Each sweep against its plain version at the peer width, in turns,
    over PEER_SWEEP_INPUTS distinct inputs, beside its bound."""
    import torch

    gen = torch.Generator().manual_seed(14)
    B, S, T, O, G = PEER_SHAPE
    ap = torch.full((B,), T, dtype=torch.int32, device=device)
    results = {}
    for key, wrapper, moving in PEER_SWEEPS:
        cases = [_peer_width_case(gen, device, moving) for _ in range(PEER_SWEEP_INPUTS)]
        inputs = [_sweep_args(c, ap, moving) for c in cases]
        k_ms, p_ms, runs = _in_turns(getattr(kernels, wrapper),
                                     _plain_sweep(kernels, key, wrapper), inputs, warm=1)
        if key in ("K1", "K3"):
            b_ms, b_by = sweep_bound(cases[0][0], O, ap, segments=G, moving=moving)
        else:
            b_ms, b_by = form_bound(cases[0][0], O, ap, G, *FORM_OPS[key], moving=moving)
        log(f"{wrapper} ({key}) at the peer width B={B}, {S}x{T} vs {O}+{G} rows "
            f"({card}), CUDA events over {PEER_SWEEP_INPUTS} distinct inputs, in turns "
            f"{runs}: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms; bound {b_ms:.5f} ms "
            f"({b_by}), {b_ms / k_ms:.1%} of it")
        results[key] = (k_ms, p_ms, b_ms, b_by)
        del cases, inputs
    return results


def _time_peer_fleet(device, card):
    """The peer fleet's tick (xla, prediction, safety, 8 tracked slots):
    host clock over FLEET_TIMED_TICKS closed-loop ticks after 10 warm-up
    ticks; returns (median, p99) ms."""
    import torch

    fleet, drive = make_peer_fleet(device)
    lat = []
    for i in range(TIMED_WARMUP + FLEET_TIMED_TICKS):
        inputs = drive.inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fleet.tick(*inputs[:4], tracked=inputs[4])  # ends in the output copy
        dt_ms = (time.perf_counter() - t0) * 1e3
        if i >= TIMED_WARMUP:
            lat.append(dt_ms)
        drive.advance(out)
    lat.sort()
    p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
    log(f"fleet tick with peers + prediction + safety, {FLEET_ROBOTS} robots, "
        f"{FLEET_TRACKED} tracked slots ({card}): host clock over {len(lat)} ticks "
        f"median {statistics.median(lat):.4f} ms, p99 {p99:.4f} ms, min {lat[0]:.4f}, "
        f"max {lat[-1]:.4f}")
    return statistics.median(lat), p99


def phase_peer_times(device, card):
    """The fleet tick and the k = 8 graph per tick with peers, prediction
    and safety, beside the same run's no-peer fleet (8 tracked slots)."""
    import torch

    plain = _time_fleet(device, FLEET_TRACKED, card)
    peers = _time_peer_fleet(device, card)
    rows = {}
    for name in ("no peers", "peers + prediction + safety"):
        if name == "no peers":
            fleet, lanes, circles = make_fleet(device, FLEET_TRACKED)
            drive = FleetDrive(lanes, circles, FLEET_TRACKED)
        else:
            fleet, drive = make_peer_fleet(device)
        inputs = drive.inputs()
        fleet.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])  # capture
        call = _median_ms(lambda: fleet.run_ticks_on_device(
            TICKS_K, *inputs[:4], tracked=inputs[4]), TICKS_TIMED)
        replay = fleet.tick_graphs[TICKS_K].graph.replay
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TICKS_TIMED):
            replay()
        stop.record()
        torch.cuda.synchronize()
        rows[name] = (call[0] / TICKS_K, start.elapsed_time(stop) / TICKS_TIMED / TICKS_K)
        del fleet
    log(f"peers + prediction + safety vs no peers ({card}), xla, {FLEET_ROBOTS} robots: "
        f"fleet tick median {peers[0]:.4f} / p99 {peers[1]:.4f} ms against "
        f"{plain[0]:.4f} / {plain[1]:.4f} ms; k={TICKS_K} graph per tick (call, "
        f"replay alone) {rows['peers + prediction + safety'][0]:.4f}, "
        f"{rows['peers + prediction + safety'][1]:.4f} ms against "
        f"{rows['no peers'][0]:.4f}, {rows['no peers'][1]:.4f} ms")
    torch.cuda.empty_cache()


# --- this slice: the split mover sweep (5e), BOX fleets (5f), K3s and K9 ------

# the split tracked fleet: the fleet slice's 64 robots and movers with the
# scan bucket at the rays (512 slots) and the 8 tracked slots in their own
# sweep (K3s), beside the tail-slot fleet (768 slots, K3)
SPLIT_TICKS = 30
SPLIT_CPU_TICKS = (0, 29)
SPLIT_ROWS = 512
SPLIT_WIDE_TICKS = 5  # ticks of the split fleet past K3s's point-major rows
# the mixed fleet: PeerDrive's 64 robots with peers, prediction, 8 tracked
# slots and the safety gate, every fourth robot a BOX of 0.5 x 0.3 m
# (half extents 0.25 x 0.15), the others circles of PEER_RADIUS
FLEET_BOX_PARAMS = (0.5, 0.3, 0.4)
BOX_EVERY = 4
BOX_FLEET_TICKS = 30
BOX_CPU_TICKS = (0, 29)
K10_SOURCE = "kompass_core_tpu_torch/csrc/goal_nearest.cu"
K10_REPLACES = ("none: the goal cost's search, XLA's in kompass_core_tpu/ops/"
                "solver.py:571 _goal_cost")
K9_SOURCE = "kompass_core_tpu_torch/csrc/box_min_dist.cu"
K9_REPLACES = "kompass_core_tpu/ops/solver.py:402"
K3S_REPLACES = "kompass_core_tpu/ops/solver.py:737"
# K9's pair: 2 FADD (dx, dy), 4 FMUL and 2 FADD (the rotation), 2 FADD and
# 2 FMNMX (the clamps), 2 FMUL and an FADD (the square) and the min
K9_PAIR_OPS = 16
K9_INPUTS = 2  # distinct inputs per timed run (the plain field takes ~0.1 s each)
# K3s's rows timed in each layout (the split fleet's 8 first: the kernels line)
K3S_TIMED_ROWS = (FLEET_TRACKED, 16, 32, 64, 128, 256)
# K3s's rows past the point-major kernel's staged rows (kPointMajorMaxRows =
# 1024, csrc/fused_min_dist.cu): its entry point refuses them
K3S_PAST_STAGED = 1100


# K9's heading probe (ROADMAP fault 2): 4 robots (two 0.5 x 0.3 m BOXes at a
# 0.2 m margin, two (0, 0) circles at 0.25 + 0.2 m) x 128 samples x 32
# steps, headings yaw0 + omega * t * dt; every point has one obstacle row
# (static, or moving at up to 0.5 m/s) on the margin's contour in its body
# frame, the even samples at margin^2 itself, the odd ones at margin^2 +
# k ulps, k in [-HEADING_SPREAD, HEADING_SPREAD]; 7 pad rows at 1e8
HEADING_HALF = ((0.25, 0.15), (0.25, 0.15), (0.0, 0.0), (0.0, 0.0))
HEADING_MARGIN = (0.2, 0.2, 0.45, 0.45)
HEADING_SHAPE = (128, 32, 8)  # samples, steps, rows
HEADING_SPREAD = 64
# the tie rule (ROADMAP fault 2): a decision may differ from the reference's
# only where the reference's d2 lies within TIE_ULPS ulps of margin^2, the
# port's CPU against JAX without FMA and the card against the CPU
TIE_ULPS = 8


def heading_probe(seed=0):
    """K9's heading probe (numpy, float32): (yaw0 [B], omega [B, S], dt,
    half [B, 2], margin [B], {moving: (px, py, rows, vel or None)}, each
    [B, S, T] or [B, O, 2]). The solver heads the body at pose t at the
    float32 yaw0 + (omega * t) * dt; each point sits at the body-frame
    offset b from its obstacle row's position o(t) = o + v * (t * dt), p
    = o(t) - R(yaw) b in float64, rounded once, with b on the contour
    where the squared distance to the box is margin^2 (+ k ulps)."""
    rng = np.random.default_rng(seed)
    S, T, O = HEADING_SHAPE
    half = np.array(HEADING_HALF, np.float32)
    margin = np.array(HEADING_MARGIN, np.float32)
    B = len(margin)
    dt = np.float32(DT)
    yaw0 = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    omega = rng.uniform(-2.0, 2.0, (B, S)).astype(np.float32)
    t = np.arange(T, dtype=np.float32)
    yaw = yaw0[:, None, None] + (omega[:, :, None] * t) * dt  # float32, as the solver
    r2 = (margin * margin).astype(np.float64)  # float32 products, exact in float64
    k = rng.integers(-HEADING_SPREAD, HEADING_SPREAD + 1, (B, S, T))
    k[:, ::2] = 0
    reach = np.sqrt(r2[:, None, None] + k * np.spacing(margin * margin)[:, None, None])
    cases = {}
    for moving in (False, True):
        v = (rng.uniform(-0.5, 0.5, (B, 2)) if moving else np.zeros((B, 2))).astype(np.float32)
        o = (rng.uniform(-0.2, 0.2, (B, 2)) - v * (T // 2) * dt).astype(np.float32)
        rows = np.full((B, O, 2), 1e8, np.float32)
        vel = np.zeros((B, O, 2), np.float32)
        rows[:, 0], vel[:, 0] = o, v
        at = (o[:, None] + v[:, None] * (t * dt)[:, None]).astype(np.float32)  # [B, T, 2]
        bx, by = np.empty((B, S, T)), np.empty((B, S, T))
        for i in range(B):
            hl, hw = (float(x) for x in half[i])
            # the contour: 4 sides at distance d, 4 quarter arcs of radius d
            # around the corners, picked in proportion to their lengths
            m = float(margin[i])
            lens = np.array([2 * hl, 2 * hw] * 2 + [m * np.pi / 2] * 4)
            part = rng.choice(8, size=(S, T), p=lens / lens.sum())
            u = rng.uniform(0.0, 1.0, (S, T))
            d = reach[i]
            sides = ((-hl + 2 * hl * u, hw + d), (hl + d, -hw + 2 * hw * u),
                     (hl - 2 * hl * u, -hw - d), (-hl - d, hw - 2 * hw * u))
            corners = ((hl, hw), (-hl, hw), (-hl, -hw), (hl, -hw))
            for j in range(4):
                on = part == j
                bx[i][on], by[i][on] = sides[j][0][on], sides[j][1][on]
                on = part == 4 + j
                a = (u + j) * np.pi / 2
                bx[i][on] = (corners[j][0] + d * np.cos(a))[on]
                by[i][on] = (corners[j][1] + d * np.sin(a))[on]
        c, s = np.cos(yaw.astype(np.float64)), np.sin(yaw.astype(np.float64))
        px = (at[:, None, :, 0] - (c * bx - s * by)).astype(np.float32)
        py = (at[:, None, :, 1] - (s * bx + c * by)).astype(np.float32)
        cases[moving] = (px, py, rows, vel if moving else None)
    return yaw0, omega, dt, half, margin, cases


def heading_probe_fields(probe, device):
    """The port's box field of each probe case on ``device``, through the
    solver's ``_min_box_dist_sq`` (its headings: torch's cos and sin of
    the yaw, on that device; K9 on the card, its plain version on the
    CPU): {moving: d2 [B, S, T] numpy}."""
    import torch

    from kompass_core_tpu_torch.ops import solver

    yaw0, omega, dt, half, _, cases = probe
    B, S = omega.shape
    T = HEADING_SHAPE[1]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    zero = dev(np.zeros(B, np.float32))
    params = solver.SolverParams(dev(np.full(B, dt, np.float32)), *([zero] * 11))
    state = dev(np.stack([np.zeros(B), np.zeros(B), yaw0], 1).astype(np.float32))
    vels = np.zeros((B, S, 3), np.float32)
    vels[..., 2] = omega
    ap = dev(np.full(B, T, np.int32))
    fields = {}
    for moving, (px, py, rows, vel) in cases.items():
        d2 = solver._min_box_dist_sq(params, state, dev(vels), dev(px), dev(py), dev(rows),
                                     ap, (dev(half[:, 0]), dev(half[:, 1])),
                                     None if vel is None else dev(vel))
        fields[moving] = d2.cpu().numpy()
    return fields


def heading_flips(got, want, margin):
    """Collision decisions (d2 < margin^2, the surface rule of
    ``_admissibility``) that differ between two fields of the probe, and
    the largest distance of ``want``'s d2 from margin^2 among them, in
    ulps of margin^2: (flips, ulps)."""
    r = np.maximum(margin, np.float32(1e-6)).astype(np.float32)
    r2 = (r * r)[:, None, None]
    flips = (got < r2) != (want < r2)
    dist = np.abs(want.astype(np.float64) - r2) / np.spacing(r2)
    return int(flips.sum()), float(dist[flips].max()) if flips.any() else 0.0


def phase_heading_flips(kernels, device):
    """ROADMAP fault 2 on the card: the heading probe's collision
    decisions with the card's torch.cos and torch.sin and K9 against the
    CPU's (torch's CPU cos and sin, K9's plain version), static and
    moving rows; not asserted to be zero (the decision is a tie rule):
    every one lies within TIE_ULPS ulps of margin^2 by the CPU's d2.
    Returns the flips per case."""
    probe = heading_probe()
    before = kernels.box_min_dist_sq.launches
    card = heading_probe_fields(probe, device)
    assert kernels.box_min_dist_sq.launches == before + len(card)
    cpu = heading_probe_fields(probe, "cpu")
    margin = probe[4]
    res = {}
    for moving in card:
        assert card[moving].shape == cpu[moving].shape
        assert np.isfinite(card[moving]).all() and np.isfinite(cpu[moving]).all()
        res[moving] = heading_flips(card[moving], cpu[moving], margin)
        points = card[moving].size
        log(f"K9 heading probe, {'moving' if moving else 'static'} rows: {res[moving][0]} "
            f"of {points} collision decisions differ between the card and the CPU "
            f"(the farthest {res[moving][1]:.0f} ulps of margin^2 from it); max |d2 "
            f"card - CPU| {float(np.abs(card[moving] - cpu[moving]).max()):.3e}")
        assert res[moving][1] <= TIE_ULPS, (
            f"K9 heading probe: a card decision differs {res[moving][1]} ulps from "
            f"margin^2, past the tie rule's {TIE_ULPS}")
    return res


def _box_case(gen, device, B, S, T, O, span=10.0, vmax=1.5):
    """K9's arguments but active_points: points, headings (torch's cos and
    sin of random yaws), rows, velocities, dt, half extents (every fourth
    robot a (0, 0) circle)."""
    import torch

    px, py, obs, vel, dt, _, _ = _moving_case(gen, device, B, S, T, O, 1, span, vmax)
    yaw = ((torch.rand(B, S, T, generator=gen) * 2 - 1) * math.pi).to(device)
    half = (torch.rand(B, 2, generator=gen) * 0.5).to(device)
    half[::4] = 0.0
    return px, py, torch.cos(yaw), torch.sin(yaw), obs, vel, dt, half


def _mixed_active(gen, B, T, device):
    import torch

    ap = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
    ap[0] = T
    return ap.to(device)


def phase_box_sweeps_vs_plain(kernels, device):
    """K9 (``box_min_dist_sq``) and K3s (``min_dist_sq_moving``) against
    their plain versions on the card, bit for bit, NaN where the plain
    version has it. K9 static and moving at the fleet shape (64 x 2025 x
    30 vs 768 rows, mixed active steps, per-robot extents with (0, 0)
    circles, 256 pad rows at 1e8, a point inside a footprint, NaN and inf
    rows and points, values above 1e18), at one robot (2025 x 30 vs 512)
    and on ragged tiles, at its own samples per thread and at each one;
    K3s at the split fleet's 8 rows (pads, an empty slot's NaN row) and
    past one tile of rows, and against K3's obstacle field. Returns the
    max abs errors (K3s, K9)."""
    import torch

    gen = torch.Generator().manual_seed(21)
    B, S, T, O, G = FLEET_SHAPE
    cases = []
    case = list(_box_case(gen, device, B, S, T, O))
    px, py, c, sn, obs, vel, dt, half = case
    obs[:, O - 256:], vel[:, O - 256:] = 1e8, 0.0
    obs[1, 7] = torch.stack([px[1, 3, 5], py[1, 3, 5]])
    vel[1, 7] = 0.0
    obs[2, 11, 1] = float("nan")
    obs[3, 13, 0] = float("inf")
    px[4, 8, 2] = float("nan")
    c[5, 9, 4] = float("nan")
    px[6, 10, 6], obs[6, 20] = 3e18, torch.tensor([2e19, -2e19])
    ap = _mixed_active(gen, B, T, device)
    ap[:8] = T  # the special robots' steps are all active
    cases.append(("fleet shape", case, ap))
    cases.append(("one robot", list(_box_case(gen, device, 1, S, T, 512)),
                  torch.full((1,), T, dtype=torch.int32, device=device)))
    cases.append(("S=37, T=7, O=1100 (ragged block, rows past one tile)",
                  list(_box_case(gen, device, 3, 37, 7, 1100)),
                  torch.tensor([7, 3, 1], dtype=torch.int32, device=device)))
    k9_err = 0.0
    for name, (px, py, c, sn, obs, vel, dt, half), ap in cases:
        for moving in (False, True):
            args = (px, py, c, sn, obs, vel if moving else None, dt, half, ap)
            want = (kernels.box_min_dist_sq_reference(*args),)
            for points in (None, *kernels.STATIC_POINTS):
                got = (kernels.box_min_dist_sq(*args, _points=points),)
                torch.cuda.synchronize()
                k9_err = max(k9_err, _check_nan_equal(
                    f"K9 {name} moving={moving} {points}", got, want))
            d2 = want[0]
            active = torch.arange(d2.shape[-1], device=device) < ap[:, None, None]
            assert bool(torch.isinf(d2[~active.expand_as(d2)]).all()), f"K9 {name}: mask"
            if name == "fleet shape":
                assert float(d2[1, 3, 5]) == 0.0, "K9: a row inside the footprint"
                assert bool(d2[2][active[2].expand_as(d2[2])].isnan().all())
                assert bool(d2[4, 8, 2].isnan()) and bool(d2[5, 9, 4].isnan())
                assert not bool(d2[0].isnan().any())
            log(f"box_min_dist_sq (K9) == plain, moving={moving}, at its own and "
                f"each of {kernels.STATIC_POINTS} samples per thread: {name}")
    k3s_err = 0.0
    star = kernels.POINT_MAJOR_ROWS
    for rows in (FLEET_TRACKED, star, star + 1, K3S_PAST_STAGED):
        px, py, obs, vel, dt, sx, sy = _moving_case(gen, device, B, S, T, rows, G)
        obs[:, rows - 3:], vel[:, rows - 3:] = 1e8, 0.0
        obs[7, 0, 0] = float("nan")
        px[9, S // 2, 4] = float("inf")
        vel[11, 0] = 3e38  # the moved row overflows to inf at t >= 1
        ap = _mixed_active(gen, B, T, device)
        ap[12] = 0
        want = kernels.min_dist_sq_moving_reference(px, py, obs, vel, dt, ap)
        full = kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)[0]
        layouts = (None, False) if rows == K3S_PAST_STAGED else (None, True, False)
        if rows == K3S_PAST_STAGED:
            before = kernels.min_dist_sq_moving.launches
            try:
                kernels.min_dist_sq_moving(px, py, obs, vel, dt, ap, _point_major=True)
            except RuntimeError:
                pass
            else:
                raise AssertionError(f"K3s: point-major launched {rows} rows")
            assert kernels.min_dist_sq_moving.launches == before
        for layout in layouts:
            got = kernels.min_dist_sq_moving(px, py, obs, vel, dt, ap, _point_major=layout)
            torch.cuda.synchronize()
            k3s_err = max(k3s_err, _check_nan_equal(
                f"K3s {rows} rows, layout {layout}", (got, got), (want, full)))
        assert bool(want[7].isnan().any()) and not bool(want[0].isnan().any())
        own = "point-major" if rows <= star else "K3's"
        forced = "each" if len(layouts) == 3 else "K3's (point-major refused)"
        log(f"min_dist_sq_moving (K3s) == plain == K3's obstacle field at B={B}, "
            f"{S}x{T} vs {rows} rows (its own layout: {own}; and forced into "
            f"{forced} layout): pads, a NaN row, an inf point, an overflowing row, "
            f"mixed active steps")
    return k3s_err, k9_err


def phase_split_fleet(kernels, device):
    """The split tracked fleet: 64 robots, the fleet slice's movers in
    their own sweep, SPLIT_TICKS closed-loop ticks on the card. Every tick
    (a replay of its CUDA graph, ``_tick_checked``) launches K1 (512 + 384
    rows) and K3s (8 rows) once, and the tick program makes no host sync; its outputs equal the tail-slot fleet's on the card bit for bit
    (the same inputs and carry: a min over the same rows); at
    SPLIT_CPU_TICKS 4 robots' rows agree with the CPU. Then the k = 8
    graph, replay == eager, TICKS_CALLS calls. Then SPLIT_WIDE_TICKS ticks
    of a side run past K3s's point-major rows (its launches counted apart).
    Returns the main path's launches that the card ran (the 8-slot split
    fleet's; the tail-slot fleet is the comparison)."""
    import torch

    split, lanes, circles = make_fleet(device, split=True)
    tail, _, _ = make_fleet(device)
    assert split.spec.solver.scan_size == SPLIT_ROWS and not split.spec.solver.moving_obstacles
    drive = FleetDrive(lanes, circles, FLEET_TRACKED)
    split._tick_fn = sync_guarded(split._tick_fn)
    ties, found = [], 0
    for tick in range(SPLIT_TICKS):
        inputs = drive.inputs()
        carry = [t.cpu() for t in split._carry]
        out = _tick_checked(kernels, split, tick, {"K1": 1, "K3s": 1},
                            lambda: split.tick(*inputs))
        ref = tail.tick(*inputs)
        for key in out:
            assert np.array_equal(out[key], ref[key]), f"split tick {tick}: {key} != tail"
        if tick in SPLIT_CPU_TICKS:
            _fleet_cpu_check(split, carry, out, tick, ties)
        found += int(out["found"].sum())
        drive.advance(out)
    runs = SPLIT_TICKS + split._graphed()  # the capture's warm-up ran too
    launches = _solves({"K1": runs, "K3s": runs}, runs)
    assert split._tick_fn.calls == (2 if split._graphed() else SPLIT_TICKS)
    assert found >= 0.9 * FLEET_ROBOTS * SPLIT_TICKS, "the split fleet lost its way"
    log(f"split mover sweep: {FLEET_ROBOTS} robots x {SPLIT_TICKS} ticks, scan bucket "
        f"{SPLIT_ROWS} + {FLEET_TRACKED} mover rows; == the tail-slot fleet bit for bit "
        f"every tick; found {found}/{FLEET_ROBOTS * SPLIT_TICKS}; min robot-mover "
        f"distance {drive.min_clearance:.3f} m; CPU ties {ties}")
    del tail
    drive = FleetDrive(lanes, circles, FLEET_TRACKED)
    graph, _ = _replay_calls(kernels, split, drive, device, ("K1", "K3s"), "split k-tick")
    for k, n in graph.items():
        launches[k] += n
    log(f"split k-tick loop: {TICKS_CALLS} calls of k={TICKS_K}, replay == eager bit "
        f"for bit; K1 and K3s {TICKS_K} per replay")
    del split
    # past K3s's point-major rows: its block per (robot, step) layout
    wide = kernels.POINT_MAJOR_ROWS + 1
    split, lanes, circles = make_fleet(device, tracked=wide, split=True)
    tail, _, _ = make_fleet(device, tracked=wide)
    drive = FleetDrive(lanes, circles, wide)
    for tick in range(SPLIT_WIDE_TICKS):
        inputs = drive.inputs()
        out = _tick_checked(kernels, split, tick, {"K1": 1, "K3s": 1},
                            lambda: split.tick(*inputs))
        ref = tail.tick(*inputs)
        for key in out:
            assert np.array_equal(out[key], ref[key]), f"wide split tick {tick}: {key}"
        drive.advance(out)
    runs = SPLIT_WIDE_TICKS + split._graphed()
    wide_launches = _solves({"K1": runs, "K3s": runs}, runs)
    log(f"split mover sweep with {wide} tracked slots (K3s past its point-major "
        f"{kernels.POINT_MAJOR_ROWS} rows, K3's layout): {SPLIT_WIDE_TICKS} ticks == the "
        f"tail-slot fleet bit for bit; its launches {wide_launches} (a side run: not "
        f"the main path's)")
    del split, tail
    torch.cuda.empty_cache()
    return launches


def phase_box_fleet(kernels, device):
    """The mixed circle + BOX fleet (every fourth of PeerDrive's 64 robots
    a BOX) with peers, prediction, 8 tracked slots and the safety gate:
    BOX_FLEET_TICKS closed-loop ticks on the card, K3 and K9 once each per
    tick (a graph replay, ``_tick_checked``), no host sync in the tick
    program, 4 robots' rows on BOX_CPU_TICKS against the CPU,
    the boxed robot stopped, no two robots closer than a box's half width
    plus a circle's radius; then its k = 8 graph (replay == eager).
    Returns the main path's launches."""
    import torch

    fleet, drive = make_peer_fleet(device, box_every=BOX_EVERY)
    solver = fleet.spec.solver
    assert solver.dynamic_box and not fleet.spec.split_mover_sweep
    box2 = fleet._cfg.collision_box2.cpu().numpy()
    assert np.array_equal(box2[::BOX_EVERY], np.tile(np.float32(FLEET_BOX_PARAMS[:2]) / 2,
                                                     (FLEET_ROBOTS // BOX_EVERY, 1)))
    fleet._tick_fn = sync_guarded(fleet._tick_fn)
    ties, found = [], 0
    for tick in range(BOX_FLEET_TICKS):
        inputs = drive.inputs()
        carry = [t.cpu() for t in fleet._carry]
        out = _tick_checked(kernels, fleet, tick, {"K3": 1, "K9": 1},
                            lambda: fleet.tick(*inputs[:4], tracked=inputs[4]))
        _assert_finite(out, f"box fleet tick {tick}")
        if tick in BOX_CPU_TICKS:
            _peer_cpu_check(fleet, carry, out, tick, ties)
        b = drive.boxed
        assert out["safety_factor"][b] == 0.0 and out["vx"][b] == 0.0
        found += int(out["found"].sum())
        drive.advance(out)
    clear = FLEET_BOX_PARAMS[1] / 2 + PEER_RADIUS
    log(f"mixed circle + BOX fleet: {FLEET_ROBOTS} robots ({FLEET_ROBOTS // BOX_EVERY} "
        f"BOX {FLEET_BOX_PARAMS[0]} x {FLEET_BOX_PARAMS[1]} m), peers + prediction + "
        f"safety, {BOX_FLEET_TICKS} ticks; found {found}/{FLEET_ROBOTS * BOX_FLEET_TICKS}"
        f"; closest pair {drive.min_pair:.3f} m (no contact above {clear}); boxed "
        f"robot stopped; CPU-checked rows {len(BOX_CPU_TICKS) * len(PEER_CPU_ROBOTS)}, "
        f"ties {ties}")
    assert drive.min_pair > clear, "BOX fleet robots collided"
    assert found >= 0.8 * FLEET_ROBOTS * BOX_FLEET_TICKS, "the BOX fleet lost its way"
    assert fleet._tick_fn.calls == (2 if fleet._graphed() else BOX_FLEET_TICKS)
    runs = BOX_FLEET_TICKS + fleet._graphed()  # the capture's warm-up ran too
    launches = _solves({"K3": runs, "K9": runs}, runs)
    del fleet
    fleet, drive = make_peer_fleet(device, box_every=BOX_EVERY, wall_gap=TICKS_WALL_GAP,
                                   wall_speed=TICKS_WALL_SPEED)
    graph, out = _replay_calls(kernels, fleet, drive, device, ("K3", "K9"),
                               "box k-tick")
    for k, n in graph.items():
        launches[k] += n
    assert drive.min_pair > clear, "BOX fleet robots collided inside the loop"
    log(f"mixed BOX fleet k-tick loop: {TICKS_CALLS} calls of k={TICKS_K}, replay == "
        f"eager bit for bit; closest pair {drive.min_pair:.3f} m; the wall robots' last "
        f"|vx| max {np.abs(out['vx'][drive.wall, -1]).max():.4f} m/s")
    del fleet
    torch.cuda.empty_cache()
    return launches


def phase_controllers(device):
    """Every entry of the port's controller registry built and stepped a
    few times on the card machine: DWA on the card, the host controllers
    (Stanley, DVZ, Pure Pursuit) along a curve past a post, the RGB and
    RGBD followers on a target ahead; each returns commands, finite."""
    from kompass_core_tpu_torch import control
    from kompass_core_tpu_torch.datatypes import Bbox2D, LaserScanData
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits, RobotGeometry,
        RobotType,
    )

    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=3.0, max_decel=5.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0, max_decel=6.0,
                                       max_steer=1.0))
    t = np.linspace(0.0, 1.0, 12)
    path = np.stack([6.0 * t, 1.2 * np.sin(2.0 * t)], 1)
    angles = np.linspace(-np.pi, np.pi, 180, endpoint=False)
    box = Bbox2D(top_left_corner=np.array([270, 200]), size=np.array([100, 80]))
    box.set_img_size(np.array([640, 480]))
    depth = np.zeros((480, 640), np.uint16)
    depth[200:281, 270:371] = 3000
    summary = []
    for cid in control.ControllersID:
        robot = Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                      geometry_type=RobotGeometry.Type.CYLINDER,
                      geometry_params=np.array([0.2, 0.4]))
        cls = control.ControlClasses[cid]
        if cid == control.ControllersID.DWA:
            ctl = cls(robot=robot, ctrl_limits=limits,
                      config=control.DWAConfig(max_linear_samples=10,
                                               max_angular_samples=10),
                      device=device)
        elif cid == control.ControllersID.VISION_DEPTH:
            ctl = cls(robot=robot, ctrl_limits=limits,
                      config=control.VisionRGBDFollowerConfig(target_distance_m=1.0),
                      camera_focal_length=(500.0, 500.0),
                      camera_principal_point=(320.0, 240.0))
            assert ctl.set_initial_tracking_2d_target(depth, box)
        elif cid == control.ControllersID.VISION_IMG:
            ctl = cls(robot=robot, ctrl_limits=limits)
            assert ctl.set_initial_tracking_2d_target(box)
        else:
            ctl = cls(robot=robot, ctrl_limits=limits, control_time_step=DT)
        if hasattr(ctl, "set_path") and "VISION" not in cid.name:
            ctl.set_path(path)
        oks = []
        for _ in range(5):
            scan = LaserScanData(ranges=np.full(180, 8.0), angles=angles, range_max=8.0)
            scan.ranges[88:93] = 1.5  # a post ahead
            oks.append(bool(ctl.loop_step(current_state=robot.state, laser_scan=scan,
                                          detections_2d=[box], aligned_depth_image=depth)))
            cmd = [float(getattr(ctl, k)[0]) for k in
                   ("linear_x_control", "linear_y_control", "angular_control")]
            assert all(math.isfinite(v) for v in cmd), f"{cid}: {cmd}"
            robot.set_control(velocity_x=cmd[0], velocity_y=cmd[1], omega=cmd[2])
            robot.get_state(dt=DT)
        assert any(oks), f"{cid}: no step found a command"
        summary.append(f"{cid} {sum(oks)}/5 (x {robot.state.x:.3f}, yaw "
                       f"{robot.state.yaw:.3f})")
    log(f"controller registry: {len(summary)} controllers stepped 5 times each: "
        + "; ".join(summary))


def box_bound(px, rows, active, moving):
    """K9's bound: K9_PAIR_OPS FP32 instructions per active (point, row)
    pair, and 4 per (robot, active step, row) to move a row; bytes: each
    point's x, y, cos and sin, the rows (and velocities), the half
    extents, one output per point, once each."""
    B, S, T = px.shape
    steps = float(active.clamp(max=T).sum())
    ops = K9_PAIR_OPS * steps * S * rows + (4.0 * steps * rows if moving else 0.0)
    nbytes = 4.0 * (4 * B * S * T + B * 2 * rows * (2 if moving else 1) + 2 * B
                    + B * S * T)
    return bound(ops, nbytes)


def _fleet_tick_ms(fleet, drive, ticks):
    """Host-clock median ms of closed-loop ``tick`` calls (after TIMED_WARMUP)."""
    import torch

    lat = []
    for i in range(TIMED_WARMUP + ticks):
        states, vels, ranges, angles, tracked = drive.inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fleet.tick(states, vels, ranges, angles, tracked=tracked)
        if i >= TIMED_WARMUP:
            lat.append((time.perf_counter() - t0) * 1e3)
        drive.advance(out)
    return statistics.median(lat)


def _fleet_graph_ms(fleet, drive):
    """Per-tick ms of the k-tick graph: host clock over whole calls with
    syncs, median of TICKS_TIMED calls, over k; and the replay alone by
    CUDA events, TICKS_TIMED replays back to back, over k."""
    import torch

    inputs = drive.inputs()
    fleet.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])  # capture
    ms = _median_ms(lambda: fleet.run_ticks_on_device(TICKS_K, *inputs[:4],
                                                      tracked=inputs[4]), TICKS_TIMED)
    replay = fleet.tick_graphs[TICKS_K].graph.replay
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TICKS_TIMED):
        replay()
    stop.record()
    torch.cuda.synchronize()
    return ms[0] / TICKS_K, start.elapsed_time(stop) / (TICKS_TIMED * TICKS_K)


def phase_goal(device, card):
    """Phase 45: K10 (``goal_nearest``) against its plain version at the
    benchmark cells' widths, one robot's DWA and the cost evaluator's, bit
    for bit in every layout, and timed (``bench_goal``). Returns (the
    largest |kernel - plain| found, (ms, plain ms, bound ms, bound by) at
    1024 x 2025 x 320)."""
    from kompass_core_tpu_torch.benchmark.kernel_bench import GOAL_SHAPES, bench_goal

    res = bench_goal(device)
    for width, r in res.items():
        layouts = ", ".join(f"{p}{' split' if s else ''} {ms:.5f}"
                            for p, s, ms in r["layout_replay_ms"])
        log(f"K10 goal_nearest {width} ({card}): layout {r['layout']}, {r['ms']:.5f} ms "
            f"by events (plain {r['plain_ms']:.5f}), {r['replay_ms']:.5f} by replay (plain "
            f"{r['plain_replay_ms']:.5f}); bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['replay_ms']:.1f}% of the replay; each layout by "
            f"replay (samples a thread): {layouts}; max abs err {r['max_abs_err']}")
    r = res["x".join(map(str, GOAL_SHAPES[0]))]
    return (max(r["max_abs_err"] for r in res.values()),
            (r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"]))


def phase_split_box_times(kernels, device, card):
    """Times of this slice, each pair in turns A, B, B, A in one run: the
    split against the tail-slot tracked fleet (tick median and k = 8
    graph per tick), the mixed BOX against the circle peer fleet (the
    same), K9 against its plain version at 64 x 2025 x 30 vs 768 static
    rows (the kernels line) and at the peer width (1344 moving rows),
    and K3s at 64 x 2025 x 30 vs 8 rows, beside their bounds. Returns
    (K3s's, K9's (ms, plain ms, bound ms, bound by))."""
    import torch

    def turns(label, makers):
        fleets = {name: make() for name, make in makers.items()}
        res = {name: [] for name in fleets}
        names = list(fleets)
        for name in (names[0], names[1], names[1], names[0]):
            fleet, drive = fleets[name]
            tick = _fleet_tick_ms(fleet, drive, FLEET_TIMED_TICKS)
            res[name].append((tick, *_fleet_graph_ms(fleet, drive)))
        for name, runs in res.items():
            log(f"{label}: {name} ({card}): tick median {statistics.mean(r[0] for r in runs):.4f} "
                f"ms (turns {[round(r[0], 4) for r in runs]}); k={TICKS_K} graph "
                f"{statistics.mean(r[1] for r in runs):.4f} ms per tick (turns "
                f"{[round(r[1], 4) for r in runs]}), the replay alone "
                f"{statistics.mean(r[2] for r in runs):.4f} ms per tick by CUDA events "
                f"(turns {[round(r[2], 4) for r in runs]})")
        del fleets
        torch.cuda.empty_cache()

    def fleet_with_drive(split):
        fleet, lanes, circles = make_fleet(device, split=split)
        return fleet, FleetDrive(lanes, circles, FLEET_TRACKED)

    turns(f"tracked fleet, {FLEET_ROBOTS} robots, {FLEET_TRACKED} slots", {
        "tail-slot (K3, 768 + 384 rows)": lambda: fleet_with_drive(False),
        "split (K1, 512 + 384 rows, + K3s, 8 rows)": lambda: fleet_with_drive(True)})
    turns(f"peer fleet, {FLEET_ROBOTS} robots, peers + prediction + safety", {
        "circles (K3)": lambda: make_peer_fleet(device),
        f"every {BOX_EVERY}th a BOX (K3 + K9)": lambda: make_peer_fleet(
            device, box_every=BOX_EVERY)})

    B, S, T, O, G = FLEET_SHAPE
    gen = torch.Generator().manual_seed(23)
    ap = torch.full((B,), T, dtype=torch.int32, device=device)
    results = {}
    for name, rows, moving in (("K9", O, False), ("K9 peer width", PEER_ROWS, True)):
        cases = [_box_case(gen, device, B, S, T, rows) for _ in range(K9_INPUTS)]
        inputs = [(px, py, c, sn, obs, vel if moving else None, dt, half, ap)
                  for px, py, c, sn, obs, vel, dt, half in cases]
        k_ms, p_ms, runs = _in_turns(kernels.box_min_dist_sq,
                                     kernels.box_min_dist_sq_reference, inputs, warm=1)
        g_ms = _graph_ms(kernels.box_min_dist_sq, inputs)
        b_ms, b_by = box_bound(cases[0][0], rows, ap, moving)
        log(f"box_min_dist_sq ({name}) at B={B}, {S}x{T} vs {rows} "
            f"{'moving' if moving else 'static'} rows ({card}), CUDA events over "
            f"{K9_INPUTS} distinct inputs, in turns {runs}: kernel {k_ms:.5f} ms "
            f"(graph replay {g_ms:.5f} ms), plain {p_ms:.5f} ms; bound {b_ms:.5f} ms "
            f"({b_by}, {K9_PAIR_OPS} per pair), {b_ms / k_ms:.1%} of it, "
            f"{b_ms / g_ms:.1%} of the replay")
        results[name] = (k_ms, p_ms, b_ms, b_by)
        del cases, inputs
    k3s = None
    for rows in K3S_TIMED_ROWS:
        cases = [_moving_case(gen, device, B, S, T, rows, 1)
                 for _ in range(FLEET_KERNEL_INPUTS)]
        inputs = [(px, py, obs, vel, dt, ap) for px, py, obs, vel, dt, _, _ in cases]
        b_ms, b_by = form_bound(cases[0][0], rows, ap, 0, 6, 0, row_ops=4,
                                moving=True, fields=1)
        if rows == FLEET_TRACKED:  # the kernels line: the split fleet's rows
            k_ms, p_ms, runs = _in_turns(kernels.min_dist_sq_moving,
                                         kernels.min_dist_sq_moving_reference, inputs)
            g_ms = _graph_ms(kernels.min_dist_sq_moving, inputs)
            log(f"min_dist_sq_moving (K3s) at B={B}, {S}x{T} vs {rows} rows ({card}), "
                f"CUDA events over {FLEET_KERNEL_INPUTS} distinct inputs, in turns {runs}: "
                f"kernel {k_ms:.5f} ms (graph replay {g_ms:.5f} ms), plain {p_ms:.5f} ms; "
                f"bound {b_ms:.5f} ms ({b_by}), {b_ms / k_ms:.1%} of it, "
                f"{b_ms / g_ms:.1%} of the replay")
            k3s = (k_ms, p_ms, b_ms, b_by)
        # each layout by graph replay and by events, in turns point-major,
        # K3's, K3's, point-major
        layouts = {True: [], False: []}
        for layout in (True, False, False, True):
            def fn(*args, _layout=layout):
                return kernels.min_dist_sq_moving(*args, _point_major=_layout)
            layouts[layout].append((_graph_ms(fn, inputs), _events_ms(fn, inputs)))
        pm, k3 = ([statistics.mean(r[i] for r in layouts[key]) for i in (0, 1)]
                  for key in (True, False))
        own = "point-major" if rows <= kernels.POINT_MAJOR_ROWS else "K3's"
        log(f"K3s layouts at B={B}, {S}x{T} vs {rows} rows ({card}; its own: {own}): "
            f"point-major {pm[0]:.5f} ms by graph replay, {pm[1]:.5f} by events "
            f"({b_ms / pm[0]:.1%} of the bound by replay); K3's layout {k3[0]:.5f} ms "
            f"by replay, {k3[1]:.5f} by events ({b_ms / k3[0]:.1%}); bound {b_ms:.5f} "
            f"ms ({b_by}); replay turns {[round(r[0], 5) for r in layouts[True]]} vs "
            f"{[round(r[0], 5) for r in layouts[False]]}")
        del cases, inputs
    torch.cuda.empty_cache()
    return k3s, results["K9"]


def _device_us(event):
    """An averaged profiler event's own device time, in us."""
    return getattr(event, "self_device_time_total", 0.0)


def phase_replay_profile(device, card):
    """One ``torch.profiler`` pass over one k = 8 replay of the tail-slot
    and of the split tracked fleet (64 robots, 8 slots): the ten kernels
    with the most device time and their share of the replay's. Fails if
    the profiler records no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, split in (("tail-slot", False), ("split", True)):
        fleet, lanes, circles = make_fleet(device, split=split)
        drive = FleetDrive(lanes, circles, FLEET_TRACKED)
        inputs = drive.inputs()
        fleet.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])  # capture
        replay = fleet.tick_graphs[TICKS_K].graph.replay
        replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            replay()
            torch.cuda.synchronize()
        timed = [e for e in prof.key_averages() if _device_us(e) > 0]
        total = sum(_device_us(e) for e in timed)
        if not timed or total <= 0:
            raise RuntimeError(f"torch.profiler recorded no device time in the {name} "
                               f"fleet's k={TICKS_K} replay")
        top = sorted(timed, key=_device_us, reverse=True)[:10]
        log(f"replay profile, {name} fleet, {FLEET_ROBOTS} robots, k={TICKS_K} ({card}): "
            f"{len(timed)} kernels, {total / 1e3:.4f} ms of device time "
            f"({total / 1e3 / TICKS_K:.4f} ms per tick); the ten with the most:")
        for e in top:
            log(f"  {_device_us(e) / 1e3:.4f} ms ({_device_us(e) / total:.1%}), "
                f"{e.count} launches: {e.key[:120]}")
        del fleet, prof
        torch.cuda.empty_cache()


# --- global planning (phases 27-30) ------------------------------------------
# the reference's own planner problem (``benchmark/planner_bench.py``'s:
# PLAN_ROBOT, PLAN_START, PLAN_GOAL, PLAN_CONFIG and plan_problem, imported
# at the top): the recorded turtlebot map, a cylinder robot of radius
# 0.1 m, 512 roadmap samples, 1024 tree iterations

PLAN_EXTRA_IDS = ("FMTstar", "AITstar")  # registry ids with no reference row
PLAN_REL = 1e-4  # card vs CPU on the same draws: nodes and costs
PLAN_REPLAY_ITERS = 100  # graph == eager: 3 chunks of 32 and a remainder of 4
PLAN_TIMED = ("RRTstar", "RRTConnect", "EST")
PLAN_TIMED_ITERS = 128  # 4 chunks
PLAN_FLEET_ROBOTS = 16


def make_planner(planner_id, device, problem=None, **overrides):
    """A port ``GlobalPlanner`` on ``device`` set up on the turtlebot
    problem (or ``problem`` = (meta, cloud, start, goal))."""
    from kompass_core_tpu_torch.models import Robot, RobotGeometry, RobotType
    from kompass_core_tpu_torch.planning import GlobalPlanner, GlobalPlannerConfig

    robot = Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array(PLAN_ROBOT))
    cfg = GlobalPlannerConfig(planner_id=planner_id, **{**PLAN_CONFIG, **overrides})
    planner = GlobalPlanner(robot, config=cfg, device=device)
    if problem is None:
        meta, cloud, _ = plan_problem()
        start, goal = PLAN_START, PLAN_GOAL
    else:
        meta, cloud, start, goal = problem
    planner.setup_problem(meta, *start, *goal, cloud)
    return planner


def check_plan(planner, path, what):
    """The path starts at the start, ends within ``goal_tolerance`` of the
    goal, and every segment is free by the planner's host check."""
    prob = planner._problem
    assert path is not None and len(path) >= 2, f"{what}: no path"
    assert np.allclose(path[0], prob["start"], atol=1e-6), f"{what}: starts at {path[0]}"
    miss = float(np.hypot(*(np.asarray(path[-1], np.float64) - prob["goal"])))
    assert miss <= planner._config.goal_tolerance, f"{what}: ends {miss} m off the goal"
    for a, b in zip(path[:-1], path[1:]):
        assert planner._segment_free_host(a, b), f"{what}: segment {a} -> {b} collides"


def phase_planners(device, card):
    """Phase 27: every registry id solves the turtlebot problem on the
    card (graph replay), the ids of ``PLAN_TIMED`` twice; solved, length,
    ratio to the reference's, first (capture included) and second solve
    seconds."""
    import torch

    from kompass_core_tpu_torch.planning import planner_registry

    _, _, ref = plan_problem()
    ids = list(ref) + [i for i in PLAN_EXTRA_IDS if i not in ref]
    assert sorted(ids) == sorted(planner_registry), sorted(set(planner_registry) ^ set(ids))
    rows = []
    t_phase = time.perf_counter()
    for pid in ids:
        planner = make_planner(pid, device)
        secs = []
        for _ in range(2 if pid in PLAN_TIMED else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = planner.solve()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            check_plan(planner, path, pid)
        length = planner.path_cost
        ref_len = float(ref[pid]["solution_len"]) if pid in ref else 0.0
        ratio = length / ref_len if ref_len > 0 else None
        rows.append({"planner": pid, "solved": True, "length": length,
                     "ref_length": ref_len or None, "ratio": ratio,
                     "first_s": secs[0], "second_s": secs[1] if secs[1:] else None})
        log(f"planner {pid}: solved, length {length:.4f} m"
            + (f" ({ratio:.3f} of the reference's {ref_len:.4f})" if ratio else
               " (no reference row)")
            + f", first solve {secs[0]:.3f} s (capture included)"
            + (f", second {secs[1]:.3f} s" if secs[1:] else "") + f" ({card})")
        del planner
    ratios = [r["ratio"] for r in rows if r["ratio"]]
    log(f"planners: {len(rows)} of {len(ids)} solved, median length ratio "
        f"{statistics.median(ratios):.3f}, phase {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    log("planners json: " + json.dumps(rows))
    return rows


# name: (registry id, the outputs that must be equal; the rest are floats
# within PLAN_REL); "roadmap" is PRM's roadmap solve and "fleet" the fleet
# planner's, whose one scan is the relaxation ``minplus_relax``
TREE_OUT = (False, True, True, False)  # nodes, parents, chosen node, cost
BIDIR_OUT = (False, True, True, True)  # nodes, parents, found, bridge
PLAN_CORES = {"roadmap": ("PRM", (False, True)),
              "fleet": (None, (False, False, True)),
              "RRTstar": ("RRTstar", TREE_OUT), "RRTsharp": ("RRTsharp", TREE_OUT),
              "RRTConnect": ("RRTConnect", BIDIR_OUT), "EST": ("EST", TREE_OUT),
              "KPIECE1": ("KPIECE1", TREE_OUT), "SST": ("SST", TREE_OUT),
              "FMT": ("FMT", (False, True, False)), "TRRT": ("TRRT", TREE_OUT),
              "BiEST": ("BiEST", BIDIR_OUT), "PDST": ("PDST", TREE_OUT),
              "BFMT": ("BFMT", (False, True, True, True, False))}
# the 11 scan cores: the roadmap's relaxation, then the tree and wavefront
# scans
SCANS = ("roadmap",) + tuple(n for n in PLAN_CORES if n not in ("roadmap", "fleet"))


def plan_planners(device, problem=None, **overrides):
    """{name: a planner of the name's registry id (PRM for the fleet) on
    ``device``, set up on the problem} for every name of PLAN_CORES."""
    return {name: make_planner(pid or "PRM", device, problem, **overrides)
            for name, (pid, _) in PLAN_CORES.items()}


def fleet_queries(planner, robots, seed):
    """(starts, goals) of ``robots`` robots, half from around the
    problem's start to around its goal and half the other way, each at a
    free cell center within 0.6 m."""
    prob = planner._problem
    rng = np.random.default_rng(seed)
    res, origin = float(prob["resolution"]), prob["origin"]
    cells = np.argwhere(~planner._blocked_host.numpy())[:, ::-1]  # free (x, y)
    centers = (cells + 0.5).astype(np.float32) * res + origin

    def near(point):
        pool = centers[np.hypot(*(centers - point).T) < 0.6]
        return pool[rng.choice(len(pool), robots, replace=False)]

    half = robots // 2
    a, b = near(prob["start"]), near(prob["goal"])
    pts = np.concatenate([a[:half], b[half:], b[:half], a[half:]])
    return pts[:robots], pts[robots:]


def planning_draws(planners, seed=0):
    """Every core's random input at its planner's sizes, made once on the
    CPU from ``seed`` by the registry's own ``draws`` (name -> a tuple of
    [iterations, ...] tensors, or a roadmap's or wavefront's samples; the
    fleet's: its queries and samples)."""
    from kompass_core_tpu_torch.planning.planner import _uniform_points, core_registry

    draws = {}
    for j, (name, (pid, _)) in enumerate(PLAN_CORES.items()):
        planner = planners[name]
        prob = planner._problem
        if pid is None:
            starts, goals = fleet_queries(planner, PLAN_FLEET_ROBOTS, seed + j)
            samples = _uniform_points(seed + j, planner._config.num_samples, prob)
            draws[name] = (starts, goals, samples)
            continue
        d = core_registry[pid].draws(planner, prob, seed + j)
        draws[name] = d(0, planner._config.max_iterations) if callable(d) else d
    return draws


def run_core(planner, name, draws, graphs):
    """The device program of ``name`` on its planner's device, with the
    arguments ``solve()`` passes (``solve_fleet``'s for the fleet) and the
    draws given."""
    from kompass_core_tpu_torch.planning.fleet_planner import fleet_run
    from kompass_core_tpu_torch.planning.planner import core_registry

    pid = PLAN_CORES[name][0]
    if pid is None:
        return fleet_run(planner, planner._problem, *draws[name], graphs)
    return core_registry[pid].run(planner, planner._problem, draws[name], graphs)


def torch_from(a):
    import torch

    return torch.from_numpy(np.asarray(a))


def _prefix(draws, p):
    """The first p iterations of a core's draws; node-wide Gumbel noise
    cut to the p + 2 nodes a p-iteration scan holds."""
    width = draws[0].shape[0] + 2
    return tuple(d[:p, :p + 2] if d.dim() == 2 and d.shape[1] == width else d[:p]
                 for d in draws)


def _outputs_agree(name, got, want):
    """None if the card's outputs equal the CPU's (discrete exactly,
    floats within PLAN_REL), else what differs."""
    import torch

    for i, (g, w, exact) in enumerate(zip(got, want, PLAN_CORES[name][1])):
        g, w = g.cpu(), w.cpu()
        if exact:
            if not torch.equal(g, w):
                return f"output {i} differs"
            continue
        if not torch.equal(torch.isinf(g), torch.isinf(w)):
            return f"output {i}: infinities differ"
        fin = torch.isfinite(w)
        if not torch.allclose(g[fin].double(), w[fin].double(), rtol=PLAN_REL, atol=0):
            return f"output {i}: beyond rel {PLAN_REL}"
    return None


def _split_iteration(name, device, draws, iterations):
    """The first iteration after which a tree core's card and CPU runs
    differ in a discrete output, by bisection over prefixes of its draws."""
    lo, hi = 0, iterations  # prefix lo agrees, prefix hi does not
    pid, exact = PLAN_CORES[name]

    def run(dev, p):
        planner = make_planner(pid, dev, max_iterations=p)
        return run_core(planner, name, {name: _prefix(draws[name], p)}, None)

    while hi - lo > 1:
        mid = (lo + hi) // 2
        a, b = run("cpu", mid), run(device, mid)
        same = all(torch_equal(x, y) for x, y, e in zip(a, b, exact) if e)
        lo, hi = (mid, hi) if same else (lo, mid)
    return lo


def torch_equal(a, b):
    import torch

    return torch.equal(a.cpu(), b.cpu())


def phase_planning_card_vs_cpu(device, card):
    """Phase 28: the twelve device programs at the bench shape (PRM's
    roadmap, the fleet's, the RRT scan as RRT* and as RRT#, and nine more
    tree and wavefront scans) on the card and on the CPU, each with the
    arguments its front end passes, on the same draws made once on the
    CPU: discrete outputs equal, nodes and costs within PLAN_REL. (Every
    root and transcendental function that feeds a decision is taken in
    float64 on both, so the devices round alike.) A tree core whose runs
    differ prints the iteration after which they split, then fails."""
    iterations = PLAN_CONFIG["max_iterations"]
    cpu = plan_planners("cpu")
    gpu = plan_planners(device)
    draws = planning_draws(cpu)
    for name in PLAN_CORES:
        t0 = time.perf_counter()
        want = run_core(cpu[name], name, draws, None)
        got = run_core(gpu[name], name, draws, gpu[name]._graphs)
        problem = _outputs_agree(name, got, want)
        if problem is not None and name not in ("roadmap", "fleet", "FMT", "BFMT"):
            split = _split_iteration(name, device, draws, iterations)
            problem += f"; the runs split after iteration {split}"
        assert problem is None, f"card vs CPU, {name}: {problem}"
        log(f"card == CPU: {name} ({time.perf_counter() - t0:.1f} s)")


def phase_planning_replay(device, card):
    """Phase 29: each of the 11 scan cores replayed as CUDA graphs (3 chunks
    of 32 iterations and a remainder of 4, captured once and replayed on a
    second call) equals its eager loop on the card bit for bit; then
    eager against replay per iteration (median of 2 runs of 128
    iterations) for RRT*, RRT-Connect and EST at the bench's shapes."""
    import torch

    from kompass_core_tpu_torch.planning._scan import EAGER

    planners = plan_planners(device, max_iterations=PLAN_REPLAY_ITERS)
    draws = planning_draws(planners, seed=7)
    graphs = {}
    for name in SCANS:
        eager = run_core(planners[name], name, draws, EAGER)
        for call in range(2):
            replay = run_core(planners[name], name, draws, graphs)
            for i, (r, e) in enumerate(zip(replay, eager)):
                assert torch.equal(r, e), f"{name}: replay {call} output {i} != eager"
        log(f"graph replay == eager: {name}")
    log(f"captured chunks: {len(graphs)}")
    iterations = PLAN_TIMED_ITERS
    planners = plan_planners(device, max_iterations=iterations)
    draws = planning_draws(planners, seed=8)
    for name in PLAN_TIMED:
        ms = {}
        for mode, graphs in (("eager", EAGER), ("replay", {})):
            run_core(planners[name], name, draws, graphs)  # warm-up, capture
            med, _, _ = _median_ms(
                lambda: run_core(planners[name], name, draws, graphs), 2)
            ms[mode] = med / iterations
        log(f"{name} per iteration: eager {ms['eager']:.4f} ms, replay "
            f"{ms['replay']:.4f} ms ({ms['eager'] / ms['replay']:.1f}x), "
            f"{iterations} iterations ({card})")


def phase_planning_fleet(device, card):
    """Phase 30: ``solve_fleet`` for 16 robots on the turtlebot map: every
    robot solves with a valid path; the one-dispatch roadmap solve timed."""
    from kompass_core_tpu_torch.planning.fleet_planner import fleet_run
    from kompass_core_tpu_torch.planning.planner import _uniform_points

    planner = make_planner("PRM", device)
    prob = planner._problem
    starts, goals = fleet_queries(planner, PLAN_FLEET_ROBOTS, 3)
    t0 = time.perf_counter()
    paths = planner.solve_fleet(starts, goals)
    total = time.perf_counter() - t0
    for i, path in enumerate(paths):
        assert path is not None, f"fleet robot {i} unsolved"
        assert np.allclose(path[0], starts[i], atol=1e-6)
        assert np.allclose(path[-1], goals[i], atol=1e-6)
        for a, b in zip(path[:-1], path[1:]):
            assert planner._segment_free_host(a, b), f"fleet robot {i} collides"
    cfg = planner._config
    samples = _uniform_points(3, cfg.num_samples, prob)
    M = 2 * PLAN_FLEET_ROBOTS + cfg.num_samples

    def dispatch():
        return fleet_run(planner, prob, starts, goals, samples, planner._graphs)

    dispatch()
    med, lo, hi = _median_ms(dispatch, 5)
    lengths = [float(np.hypot(*np.diff(p, axis=0).T).sum()) for p in paths]
    log(f"fleet planner: {PLAN_FLEET_ROBOTS} of {PLAN_FLEET_ROBOTS} robots solved "
        f"(median length {statistics.median(lengths):.3f} m) in {total:.3f} s with "
        f"the shortcut pass; one dispatch ({M} nodes, {min(M, 128)} relaxations) "
        f"{med:.3f} ms (min {lo:.3f}, max {hi:.3f}) ({card})")


# --- serving (phases 31-34) ---------------------------------------------------

SERVE_INPUTS = 10  # flagship packed inputs served per artifact
SERVE_CALLS = 5  # chained calls per fleet artifact
SERVE_TIMED = 5  # calls per timer, the median kept
# (backend, tracked slots, the kernel one tick launches, a k = 8 artifact too)
SERVE_FORMS = (("xla", FLEET_TRACKED, "K3", True),
               ("pallas", FLEET_TRACKED, "K7", True),
               ("pallas_vpu", FLEET_TRACKED, "K8", True),
               ("pallas_vpu", 0, "K6", False))
RESUME_TICKS = (4, 3)  # ticks before the snapshot, ticks compared after it
FLAGSHIP_TICK_RANGE = "2.54-5.41 ms"  # PERF.md, the flagship tick's medians so far
OP_NAMES = {"K1": "fused_min_dist_sq", "K3": "fused_min_dist_sq_moving",
            "K6": "fused_min_dist_sq_broadcast", "K7": "fused_min_dist_sq_moving_expanded",
            "K8": "fused_min_dist_sq_moving_broadcast"}

# a serving process: it imports the serving module alone, which must load
# no ops or control module, then loads the artifact on the card and serves
# the buffers (argv: artifact, buffers .npy, outputs .npy)
FRESH_LOAD = (
    "import sys, numpy as np, torch\n"
    "import kompass_core_tpu_torch.serving as serving\n"
    "banned = [m for m in sys.modules if m.startswith(\n"
    "    ('kompass_core_tpu_torch.ops', 'kompass_core_tpu_torch.control'))]\n"
    "assert not banned, f'serving import pulled in {banned}'\n"
    "art = serving.load_artifact(sys.argv[1], device='cuda')\n"
    "from kompass_core_tpu_torch.ops import kernels\n"
    "outs = []\n"
    "for buf in np.load(sys.argv[2]):\n"
    "    n = kernels.fused_min_dist_sq.launches\n"
    "    outs.append(art.call(buf).cpu().numpy())\n"
    "    assert kernels.fused_min_dist_sq.launches == n + 1\n"
    "np.save(sys.argv[3], np.stack(outs))\n"
    "print('fresh process served', len(outs), 'calls')\n"
)


# a fleet artifact's export in a process of its own (argv: the sizes this
# process runs at as JSON, backend, tracked slots, k or 0, robots, path):
# the fleet built on the CPU as phase 32 builds it on the card, its program
# traced there for both device types; prints the export's seconds
EXPORT_FLEET = (
    "import json, sys, time, torch\n"
    "import chip_smoke as cs\n"
    "from kompass_core_tpu_torch import serving\n"
    "vars(cs).update({k: tuple(v) if isinstance(v, list) else v\n"
    "                 for k, v in json.loads(sys.argv[1]).items()})\n"
    "backend, tracked, k, robots, path = sys.argv[2:7]\n"
    "fleet, _ = cs._serving_fleet(torch.device('cpu'), backend, int(tracked), int(robots))\n"
    "t0 = time.perf_counter()\n"
    "kw = dict(device=torch.device('cpu'), platforms=('cpu', 'cuda'))\n"
    "if int(k):\n"
    "    serving.export_fleet_ticks_on_device(fleet, int(k), path, **kw)\n"
    "else:\n"
    "    serving.export_fleet_tick(fleet, path, **kw)\n"
    "print(time.perf_counter() - t0)\n"
)
SHARD_LABEL = "xla/8 tick, half the robots"


def _fleet_label(backend, tracked, k):
    return f"{backend}/{tracked} {'tick' if k is None else f'k={k}'}"


def export_fleet_artifacts(tmp, times):
    """The fleet artifacts of phases 32 and 33 (SERVE_FORMS' tick and k-tick
    programs, and half the tracked fleet's tick), each exported in a process
    of its own on the CPU, all at once (the tracing is host work and takes
    minutes one after another), for loading on the card. Returns {label:
    path}; the export seconds go into ``times``."""
    sizes = json.dumps({"FLEET_ROBOTS": FLEET_ROBOTS, "SAMPLES": SAMPLES,
                        "RAYS": RAYS, "FLEET_SHAPE": FLEET_SHAPE})
    jobs = [(_fleet_label(b, t, k), b, t, k, FLEET_ROBOTS)
            for b, t, _, loop in SERVE_FORMS for k in ((None, TICKS_K) if loop else (None,))]
    jobs.append((SHARD_LABEL, "xla", FLEET_TRACKED, None, FLEET_ROBOTS // 2))
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, paths = {}, {}
    t0 = time.perf_counter()
    try:
        for n, (label, backend, tracked, k, robots) in enumerate(jobs):
            paths[label] = os.path.join(tmp, f"fleet_{n}.ktpuart")
            procs[label] = subprocess.Popen(
                [sys.executable, "-c", EXPORT_FLEET, sizes, backend, str(tracked),
                 str(k or 0), str(robots), paths[label]],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        for label, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, f"{label}: export failed\n{err[-4000:]}"
            times[label] = {"export_s": float(out.split()[-1]),
                            "bytes": os.path.getsize(paths[label])}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    times["fleet exports"] = {"processes": len(jobs),
                              "wall_s": time.perf_counter() - t0}
    return paths


def served_kernels(art):
    """The kernel operators in a served program's graph, by name."""
    return sorted(str(n.target).split(".")[1] for n in art.program.graph.nodes
                  if str(n.target).startswith("kompass_torch."))


def flagship_inputs(device, count):
    """The flagship's spec and the packed inputs of its first ``count``
    closed-loop ticks (phase 4's DWA and scene)."""
    robot = make_robot()
    dwa = make_dwa(robot, device)
    circles = obstacle_circles()
    bufs = []
    for i in range(count):
        assert dwa.loop_step(current_state=robot.state,
                             laser_scan=cast_scan(robot.state, circles)), f"tick {i}"
        spec, buf, _ = dwa.last_solver_io
        bufs.append(buf.copy())
        apply_first_command(robot, dwa)
    shape = (spec.num_samples, spec.max_points, spec.scan_size, spec.seg_size)
    assert shape == SLICE_SHAPE, f"solved {shape}, not {SLICE_SHAPE}"
    return spec, bufs


def _events_median_ms(fn, repeats=SERVE_TIMED):
    """Median CUDA-event ms of one call of ``fn``, over ``repeats`` calls."""
    import torch

    fn()
    lat = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        lat.append(start.elapsed_time(stop))
    return statistics.median(lat)


def _turns(timer, live, served):
    """Medians of ``live`` and ``served`` by ``timer``, in turns live,
    served, served, live: (live ms, served ms)."""
    runs = [timer(live), timer(served), timer(served), timer(live)]
    return (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2


def _tally(served, made):
    for key, n in made.items():
        served[key] = served.get(key, 0) + n


def _load_timed(load, first_args, times, label):
    """Load an artifact and make its first call: the cold-load seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = load()
    art.call(*first_args)
    torch.cuda.synchronize()
    times[label]["cold_load_s"] = time.perf_counter() - t0
    return art


def phase_serving_solver(kernels, device, tmp, times):
    """Phase 31: the flagship packed solver exported on the card, then
    loaded in this process, in a fresh process that imports only the
    serving module, and exported on the CPU and loaded on the card: every
    served output equals the live solver's with ``torch.equal``, and each
    served call launches K1 once. Returns the served calls' launches."""
    import torch

    from kompass_core_tpu_torch import serving
    from kompass_core_tpu_torch.ops.solver import get_packed_dwa_solver

    spec, bufs = flagship_inputs(device, SERVE_INPUTS)
    live = get_packed_dwa_solver(spec, device)
    want = [live(b) for b in bufs]
    served = {}

    def serve(art, what):
        assert served_kernels(art) == ["fused_min_dist_sq", "goal_nearest"], (
            served_kernels(art))
        for i, (buf, w) in enumerate(zip(bufs, want)):
            before = kernels.launch_counts()
            out = art.call(buf)
            made = _launches_made(kernels, before)
            assert made == _solves({"K1": 1}, 1), f"{what} call {i}: launches {made}"
            assert torch.equal(out, w), f"{what} call {i}: served != live"
            _tally(served, made)

    t = times["solver"] = {}
    path = os.path.join(tmp, "solver.ktpuart")
    t0 = time.perf_counter()
    serving.export_packed_solver(spec, path, device=device)
    t["export_s"] = time.perf_counter() - t0
    t["bytes"] = os.path.getsize(path)
    art = _load_timed(lambda: serving.load_packed_solver(path, device=device)[0],
                      (bufs[0],), times, "solver")
    assert serving.load_packed_solver(path, device=device)[1] == spec
    serve(art, "same-process load")

    cpu_path = os.path.join(tmp, "solver_cpu.ktpuart")
    t0 = time.perf_counter()
    serving.export_packed_solver(spec, cpu_path, device=torch.device("cpu"),
                                 platforms=("cpu", "cuda"))
    t["cpu_export_s"] = time.perf_counter() - t0
    cpu_art, _ = serving.load_packed_solver(cpu_path, device=device)
    assert cpu_art.device == device
    serve(cpu_art, "CPU-exported artifact")

    bufs_path, outs_path = (os.path.join(tmp, n) for n in ("bufs.npy", "outs.npy"))
    np.save(bufs_path, np.stack(bufs))
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FRESH_LOAD, path, bufs_path, outs_path],
                          cwd=root, env=env, capture_output=True, text=True, timeout=600)
    t["fresh_process_s"] = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    fresh = np.load(outs_path)
    for i, w in enumerate(want):
        assert torch.equal(torch.from_numpy(fresh[i]), w.cpu()), f"fresh process call {i}"

    dev_buf = torch.from_numpy(bufs[0]).to(device)
    t["live_ms"], t["served_ms"] = _turns(
        _events_median_ms, lambda: live(dev_buf), lambda: art.call(dev_buf))
    log(f"served packed solver (flagship {SLICE_SHAPE}): {3 * SERVE_INPUTS} served "
        f"calls == live with torch.equal (same-process load, CPU-exported artifact "
        f"loaded on the card, fresh process: {proc.stdout.strip()}), K1 once per call")
    return served


def _serving_fleet(device, backend, tracked, robots=None):
    """A closed-loop fleet of ``make_fleet`` whose tick, like its k-tick
    loop, runs ``backend``'s kernels, with its first inputs packed."""
    from kompass_core_tpu_torch.ops.fleet_solver import make_fleet_tick

    fleet, lanes, circles = make_fleet(device, tracked, backend=backend, robots=robots)
    if backend != "xla":
        fleet._tick_fn = make_fleet_tick(fleet.spec, device)
    drive = FleetDrive(lanes, circles, tracked)
    fleet._prepare_tick_inputs(*drive.inputs())
    return fleet, drive


def _fleet_outputs_equal(live, served, label):
    """``DeviceFleet``'s output dict against a served output matrix
    ([N, F] or [N, k, F]) of the same call, bit for bit."""
    from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS

    got = served[:FLEET_ROBOTS].cpu().numpy()
    for i, name in enumerate(OUT_FIELDS):
        col = got[..., i]
        col = col > 0.5 if name in ("found", "reached") else col
        assert np.array_equal(col, live[name]), f"{label}: {name} served != live"


def _serve_fleet(kernels, fleet, drive, art, key, k, label, served):
    """SERVE_CALLS chained calls of a fleet artifact (the tick, or the
    k-tick loop when ``k``) beside the live ``DeviceFleet.tick`` or
    ``run_ticks_on_device`` on the same inputs: outputs, final states and
    carry bit for bit; the served call launches ``key``'s kernel once per
    tick."""
    import torch

    carry = None
    for call in range(SERVE_CALLS):
        inputs = drive.inputs()
        fleet._prepare_tick_inputs(*inputs)
        args = fleet.tick_example_args()
        if carry is not None:
            args = (*args[:2], carry, *args[3:])
        before = kernels.launch_counts()
        result = art.call(*args)
        made = _launches_made(kernels, before)
        assert made == _solves({key: k or 1}, k or 1), f"{label} call {call}: launches {made}"
        _tally(served, made)
        carry = result[0]
        what = f"{label} call {call}"
        if k:
            live = fleet.run_ticks_on_device(k, *inputs[:4], tracked=inputs[4])
            _fleet_outputs_equal(live, result[1], what)
            assert np.array_equal(live["final_states"],
                                  result[2][:FLEET_ROBOTS].cpu().numpy()), what
            drive.advance_ticks(live, k)
        else:
            live = fleet.tick(*inputs[:4], tracked=inputs[4])
            _fleet_outputs_equal(live, result[1], what)
            drive.advance(live)
        assert all(torch.equal(a, b) for a, b in zip(carry, fleet._carry)), f"{what}: carry"


def phase_serving_fleet(kernels, device, paths, times):
    """Phase 32: the 64-robot fleet with 8 tracked slots as a tick artifact
    and a k = 8 artifact per backend (``xla``: K3, ``pallas``: K7,
    ``pallas_vpu``: K8), and the static ``pallas_vpu`` fleet's tick (K6),
    each exported on the CPU (``export_fleet_artifacts``) and loaded on the
    card; each served == live over SERVE_CALLS chained calls. Returns the
    served calls' launches."""
    import torch

    from kompass_core_tpu_torch import serving

    served = {}
    for backend, tracked, key, loop in SERVE_FORMS:
        fleet, drive = _serving_fleet(device, backend, tracked)
        for k in (None, TICKS_K) if loop else (None,):
            label = _fleet_label(backend, tracked, k)
            t = times[label]
            art = _load_timed(lambda: serving.load_artifact(paths[label], device=device),
                              fleet.tick_example_args(), times, label)
            assert art.device == device
            assert served_kernels(art) == sorted([OP_NAMES[key], "goal_nearest"] * (k or 1)), (
                served_kernels(art))
            _serve_fleet(kernels, fleet, drive, art, key, k, label, served)
            args = fleet.tick_example_args()
            live = (fleet._tick_fn if k is None else fleet.ticks_fn(k))
            t["live_ms"], t["served_ms"] = _turns(
                lambda fn: _median_ms(fn, SERVE_TIMED)[0],
                lambda: live(*args), lambda: art.call(*args))
            if k:
                inputs = drive.inputs()
                t["replay_ms"] = _median_ms(lambda: fleet.run_ticks_on_device(
                    k, *inputs[:4], tracked=inputs[4]), SERVE_TIMED)[0]
            log(f"served fleet artifact ({label}, {FLEET_ROBOTS} robots): "
                f"{SERVE_CALLS} chained calls == live bit for bit, {key} "
                f"{k or 1} per call")
            del art
        del fleet
        torch.cuda.empty_cache()
    return served


def phase_serving_resume(kernels, device, tmp, paths):
    """Phase 33: a snapshot of the tracked fleet after RESUME_TICKS[0] ticks,
    through a disk round trip, restored into a new fleet on the card:
    RESUME_TICKS[1] ticks equal the original's bit for bit. Then the tick
    artifact of half the fleet served across [cuda, cuda]
    (``sharded_fleet_call``) equals the whole fleet's tick. Returns the
    served calls' launches."""
    import torch

    from kompass_core_tpu_torch import serving

    fleet, drive = _serving_fleet(device, "xla", FLEET_TRACKED)
    for _ in range(RESUME_TICKS[0]):
        inputs = drive.inputs()
        drive.advance(fleet.tick(*inputs[:4], tracked=inputs[4]))
    path = os.path.join(tmp, "fleet_state.npz")
    np.savez(path, **fleet.state_dict())
    resumed, _ = _serving_fleet(device, "xla", FLEET_TRACKED)
    resumed.load_state_dict(dict(np.load(path)))
    for tick in range(RESUME_TICKS[1]):
        inputs = drive.inputs()
        want = fleet.tick(*inputs[:4], tracked=inputs[4])
        got = resumed.tick(*inputs[:4], tracked=inputs[4])
        for name, col in want.items():
            assert np.array_equal(col, got[name]), f"resumed tick {tick}: {name}"
        drive.advance(want)
    log(f"snapshot resume on the card: {RESUME_TICKS[1]} ticks after a snapshot at "
        f"tick {RESUME_TICKS[0]} == the original fleet bit for bit")
    del resumed

    art = serving.load_artifact(paths[SHARD_LABEL], device=device)
    fleet._prepare_tick_inputs(*drive.inputs())
    args = fleet.tick_example_args()
    live_carry, live_out = fleet._tick_fn(*args)
    before = kernels.launch_counts()
    carry, out = serving.sharded_fleet_call(art, args, [device, device])
    made = _launches_made(kernels, before)
    assert made == _solves({"K3": 2}, 2), f"sharded call: launches {made}"
    assert np.array_equal(out, live_out.cpu().numpy()), "sharded != whole fleet"
    for a, b in zip(live_carry, carry):
        assert np.array_equal(a.cpu().numpy(), b), "sharded carry != whole fleet"
    log(f"sharded_fleet_call: a {FLEET_ROBOTS // 2}-robot tick artifact served over "
        f"[{device}, {device}] == the {FLEET_ROBOTS}-robot tick bit for bit")
    del fleet, art
    torch.cuda.empty_cache()
    return made


def phase_serving_times(card, times, tick_p50):
    """Phase 34: the serving timings of phases 31 and 32, with the card."""
    log(f"serving times ({card}):")
    for label, t in times.items():
        log(f"  {label}: " + ", ".join(
            f"{name} {value}" if isinstance(value, int) else f"{name} {value:.4f}"
            for name, value in t.items()))
    log(f"flagship DWA.loop_step median with the kernels as operators: "
        f"{tick_p50:.4f} ms (PERF.md so far: {FLAGSHIP_TICK_RANGE}) ({card})")


# --- scale-out: the robot-sharded fleet, solver and runtime -----------------

MESH_ROBOTS = 128  # the JAX north star's 100+ robots, the fleet width of phase 17
MESH_SHARDS = 2  # shards of the fleet mesh, all on the one card
MESH_TICKS = 10
MESH_K_CALLS = 2
MESH_TIMED = 10  # ticks per timer, the median kept
MESH_K_TIMED = 3  # k = 8 calls per timer
MESH_PLANNER_ROBOTS = 129  # 130 rows on 2 shards: one pad row
SP_SHARDS = 4
SP_SEED = 5
MP_PROCESSES = 2
MP_TICKS = 5
MP_TIMEOUT = 300  # seconds per worker process
RUNTIME_ROBOTS = 32
RUNTIME_TICKS = 60
MESH_WORKER = (
    "import json, sys\n"
    "import chip_smoke as cs\n"
    "vars(cs).update({k: tuple(v) if isinstance(v, list) else v\n"
    "                 for k, v in json.loads(sys.argv[1]).items()})\n"
    "sys.exit(cs.mesh_worker(*sys.argv[2:]))\n"
)


def _counted(kernels, fn):
    """(the kernels ``fn`` launched by wrapper calls, what it returned)."""
    before = kernels.launch_counts()
    out = fn()
    return _launches_made(kernels, before), out


def _outputs_equal(got, want, label):
    """Two fleets' output dicts bit for bit (``np.array_equal``, and the
    same sign of every zero)."""
    assert got.keys() == want.keys(), label
    for key in want:
        assert np.array_equal(got[key], want[key]), f"{label}: {key} differs"
        assert np.array_equal(np.signbit(got[key]), np.signbit(want[key])), (
            f"{label}: {key} signs differ")


def _tick_backend(fleet, backend, device, mesh):
    """Make ``fleet``'s single tick (not only its k-tick loop) run
    ``backend``."""
    from kompass_core_tpu_torch.ops.fleet_solver import make_fleet_tick

    fleet.spec = dataclasses.replace(fleet.spec, solver=dataclasses.replace(
        fleet.spec.solver, backend=backend))
    fleet._tick_fn = make_fleet_tick(fleet.spec, **_placed(device, mesh),
                                     peer_cfg=fleet._peer_cfg,
                                     safety=fleet._safety_cfgs is not None)


def _mesh_pair(make, device, label, **kw):
    """(the fleet over a fresh MESH_SHARDS-shard mesh of ``device``, the
    same fleet on ``device``, the mesh, the drive), from ``make``."""
    from kompass_core_tpu_torch.parallel import FleetMesh

    mesh = FleetMesh([device] * MESH_SHARDS)
    sharded, drive = make(device, mesh=mesh, **kw)
    one, _ = make(device, **kw)
    assert sharded._n == one._n == MESH_ROBOTS, label
    assert sharded.spec == one.spec, label
    return sharded, one, mesh, drive


def _peer_pair(device, backend, predict=True, tracked=FLEET_TRACKED):
    def make(dev, mesh=None):
        return make_peer_fleet(dev, backend, predict=predict, robots=MESH_ROBOTS,
                               tracked=tracked, mesh=mesh)
    return _mesh_pair(make, device, f"peers {backend}")


def _lane_pair(device, backend, tracked):
    def make(dev, mesh=None):
        fleet, lanes, circles = make_fleet(dev, tracked, backend, MESH_ROBOTS,
                                           mesh=mesh)
        _tick_backend(fleet, backend, dev, mesh)
        return fleet, FleetDrive(lanes, circles, tracked)
    return _mesh_pair(make, device, f"lanes {backend}")


def _mesh_ticks(kernels, pair, ticks, expect, label, gathers_per_tick):
    """``ticks`` closed-loop single ticks of a (mesh, one-device) pair on
    the same inputs: the mesh launches MESH_SHARDS times the one device's
    ``expect`` (K10 added) per tick (``_tick_checked``: a graph a shard
    without peers, eager with them), its outputs equal the one device's
    bit for bit, and its gathers count ``gathers_per_tick`` per tick.
    Returns the mesh launches that the card ran (a graphed mesh's
    warm-up and replays)."""
    sharded, one, mesh, drive = pair
    for tick in range(ticks):
        inputs = drive.inputs()
        got = _tick_checked(kernels, sharded, tick, expect, lambda: sharded.tick(
            *inputs[:4], tracked=inputs[4]), MESH_SHARDS)
        want = _tick_checked(kernels, one, tick, expect, lambda: one.tick(
            *inputs[:4], tracked=inputs[4]))
        _outputs_equal(got, want, f"{label} tick {tick}")
        _assert_finite(got, f"{label} tick {tick}")
        assert mesh.collectives == {"all_gather": gathers_per_tick * (tick + 1),
                                    "all_reduce": 0}, mesh.collectives
        drive.advance(want)
    runs = MESH_SHARDS * (ticks + sharded._graphed())
    return _solves({k: runs * n for k, n in expect.items()}, runs)


def _mesh_graph_calls(kernels, pair, key, label):
    """MESH_K_CALLS k = 8 calls of a (mesh, one-device) pair without peers:
    on the card each shard replays a graph of its own (the first call
    captures it: 2k wrapper calls a shard, none after), equal to the
    one-device graph bit for bit, with no collective. Returns the mesh's
    launches, counted as ``_replay_calls`` counts them."""
    sharded, one, mesh, drive = pair
    counted = 0
    for call in range(MESH_K_CALLS):
        inputs = drive.inputs()
        made, got = _counted(kernels, lambda: sharded.run_ticks_on_device(
            TICKS_K, *inputs[:4], tracked=inputs[4]))
        want = one.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])
        if sharded._graphed():
            expect = (_solves({key: 2 * TICKS_K * MESH_SHARDS}, 2 * TICKS_K * MESH_SHARDS)
                      if call == 0 else {})
        else:  # the CPU rehearsal: eager
            expect = _solves({key: TICKS_K * MESH_SHARDS}, TICKS_K * MESH_SHARDS)
        assert made == expect, f"{label} k-call {call}: wrapper calls {made}"
        _outputs_equal(got, want, f"{label} k-call {call}")
        counted += made.get(key, 0)
        drive.advance_ticks(want, TICKS_K)
    assert mesh.collectives == {"all_gather": 0, "all_reduce": 0}
    if not sharded._graphed():
        return {key: counted}
    assert len(sharded.tick_graphs[TICKS_K]) == MESH_SHARDS, "one graph per shard"
    return {key: counted + (MESH_K_CALLS - 1) * (counted // 2)}


def phase_mesh_fleet(kernels, device):
    """The 128-robot peer fleet (PeerDrive, peers with 8 ring points,
    prediction, 8 tracked slots, the safety gate) on a 2-shard mesh
    ``[cuda, cuda]`` beside the same fleet on ``cuda``, per backend
    (``xla``: K3, ``pallas``: K7, ``pallas_vpu``: K8): MESH_TICKS ticks,
    then MESH_K_CALLS calls of ``run_ticks_on_device(8)``; every output,
    ``final_states`` included, equal to the one-device fleet's bit for
    bit; the mesh launches twice the one-device count per tick (each
    shard once) and 16 per k = 8 call, and gathers once per tick and 8
    times per k = 8 call. Then one tick each of the peer fleet without
    prediction or tracked slots (K1, one gather), the tracked fleet
    without peers (K3) and the static ``pallas_vpu`` fleet (K6), those two
    with no collective; the tracked fleet without peers then makes
    MESH_K_CALLS k = 8 calls, each shard replaying its own graph
    (``_mesh_graph_calls``). Returns the mesh's launches per kernel."""
    import torch

    launches = {}

    def add(made):
        for k, n in made.items():
            launches[k] = launches.get(k, 0) + n

    for backend, key in PEER_FORMS:
        pair = _peer_pair(device, backend)
        sharded, one, mesh, drive = pair
        add(_mesh_ticks(kernels, pair, MESH_TICKS, {key: 1}, f"mesh peers {backend}", 1))
        for call in range(MESH_K_CALLS):
            inputs = drive.inputs()
            made_m, got = _counted(kernels, lambda: sharded.run_ticks_on_device(
                TICKS_K, *inputs[:4], tracked=inputs[4]))
            want = one.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])
            assert made_m == _solves({key: MESH_SHARDS * TICKS_K}, MESH_SHARDS * TICKS_K), (
                f"{backend} k-call {call}: the mesh launched {made_m}")
            _outputs_equal(got, want, f"mesh peers {backend} k-call {call}")
            assert mesh.collectives["all_gather"] == MESH_TICKS + (call + 1) * TICKS_K
            add(made_m)
            drive.advance_ticks(want, TICKS_K)
        assert drive.min_pair > 2 * PEER_RADIUS, f"{backend}: robots collided"
        log(f"mesh peer fleet ({backend}, {key}): {MESH_ROBOTS} robots on "
            f"{MESH_SHARDS} shards of {device}, {MESH_TICKS} ticks and "
            f"{MESH_K_CALLS} k={TICKS_K} calls == the one-device fleet bit for bit; "
            f"gathers {mesh.collectives}; {key} launches per tick {MESH_SHARDS} "
            f"(one device 1); closest pair {drive.min_pair:.3f} m")
        del pair, sharded, one
    for label, pair, key, gathers in (
            ("peers without prediction or tracked slots",
             _peer_pair(device, "xla", predict=False, tracked=0), "K1", 1),
            ("tracked, no peers", _lane_pair(device, "xla", FLEET_TRACKED), "K3", 0),
            ("static pallas_vpu, no peers", _lane_pair(device, "pallas_vpu", 0), "K6", 0)):
        add(_mesh_ticks(kernels, pair, 1, {key: 1}, f"mesh {label}", gathers))
        log(f"mesh fleet, {label}: 1 tick == one device bit for bit, {key} x "
            f"{MESH_SHARDS}, gathers {pair[2].collectives}")
        if key == "K3":
            made = _mesh_graph_calls(kernels, pair, key, f"mesh {label}")
            add(made)
            log(f"mesh fleet, {label}: {MESH_K_CALLS} k={TICKS_K} calls, a graph per "
                f"shard ({pair[0]._graphed()}), == the one-device graph bit for bit, "
                f"no collective; {key} launches {made}")
        del pair
    torch.cuda.empty_cache()
    return launches


def _chunks(rows):
    """``make_fleet_solver``'s dispatches for ``rows`` rows on one device."""
    return -(-rows // SOLVER_CHUNK)


def mesh_solver_bufs(spec, rows=None, seed=3):
    """``rows`` (MESH_ROBOTS) BASELINE scenarios (robot i at x = 0.1 i)."""
    rows = MESH_ROBOTS if rows is None else rows
    rng = np.random.default_rng(seed)
    return np.stack([baseline_scenario(spec, rng, i) for i in range(rows)])


def phase_mesh_solver(kernels, device):
    """``make_fleet_solver`` on 128 BASELINE scenarios over a 2-shard mesh
    for backends ``xla``, ``pallas`` and ``pallas_v1``: each shard's 64
    rows one chunk (K1 or K2 once, K4 twice, per shard), every row equal
    to the one-device solver's bit for bit, no collective; a
    ``FleetPlanner`` of 129 robots (130 rows: 65 a shard, two chunks each)
    equal to the one device, its pad row not found; then
    ``make_sample_parallel_solver`` over 4 shards on the flagship scenario,
    the omega axis split as ``tests/test_fleet.py`` splits it: K1 once a
    shard, three all-reduces, every shard's output the one-device
    full-window solve's (found, winner, cost and trajectory bit for bit;
    num_admissible counts the winning shard's samples), and the CPU port's
    sample-parallel output by the card-against-CPU rule of phase 9.
    Returns the mesh's launches per kernel."""
    from kompass_core_tpu_torch.parallel import (
        FleetMesh, FleetPlanner, make_fleet_solver, make_sample_parallel_solver,
    )

    expect = {"xla": {"K1": 1}, "pallas": {"K2": 1}, "pallas_v1": {"K4": 2}}
    launches = {}

    def add(made):
        for k, n in made.items():
            launches[k] = launches.get(k, 0) + n

    for backend in SOLVER_BACKENDS:
        spec = baseline_spec(backend)
        bufs = mesh_solver_bufs(spec)
        mesh = FleetMesh([device] * MESH_SHARDS)
        made_m, got = _counted(kernels, lambda: mesh.host_rows(
            make_fleet_solver(spec, mesh=mesh)(bufs)))
        made_1, want = _counted(kernels, lambda: make_fleet_solver(spec, device)(
            bufs).cpu().numpy())
        chunks = (MESH_SHARDS * _chunks(MESH_ROBOTS // MESH_SHARDS),
                  _chunks(MESH_ROBOTS))
        assert (made_m, made_1) == tuple(
            {k: c * n for k, n in _solves(expect[backend], 1).items()} for c in chunks), (
            backend, made_m, made_1)
        assert np.array_equal(got, want) and np.array_equal(np.signbit(got),
                                                            np.signbit(want)), backend
        assert mesh.collectives == {"all_gather": 0, "all_reduce": 0}
        found = int((got[:, 0] > 0.5).sum())
        assert found >= 0.9 * MESH_ROBOTS, f"{backend}: found {found}"
        add(made_m)
        log(f"mesh fleet solver ({backend}): {MESH_ROBOTS} scenarios on {MESH_SHARDS} "
            f"shards == one device bit for bit, launches {made_m}, found {found}, "
            f"no collective")
    spec = baseline_spec("xla")
    mesh = FleetMesh([device] * MESH_SHARDS)
    planner = FleetPlanner(spec, MESH_PLANNER_ROBOTS, mesh=mesh)
    assert planner.inputs.shape[0] == MESH_PLANNER_ROBOTS + 1
    planner.inputs[:MESH_PLANNER_ROBOTS] = mesh_solver_bufs(spec, MESH_PLANNER_ROBOTS, 4)
    made, got = _counted(kernels, planner.step)
    n = MESH_SHARDS * _chunks(len(planner.inputs) // MESH_SHARDS)
    assert made == _solves({"K1": n}, n), made
    add(made)
    want = make_fleet_solver(spec, device)(planner.inputs).cpu().numpy()
    assert np.array_equal(got, want[:MESH_PLANNER_ROBOTS])
    assert want[MESH_PLANNER_ROBOTS, 0] == 0.0, "the pad row reported found"
    log(f"mesh FleetPlanner: {MESH_PLANNER_ROBOTS} robots in {len(want)} rows on "
        f"{MESH_SHARDS} shards (K1 {made['K1']}: chunks of {SOLVER_CHUNK} a shard) == one device; "
        f"the pad row not found")

    mesh = FleetMesh([device] * SP_SHARDS, axis_name="sp")
    bufs = np.stack([baseline_scenario(spec, np.random.default_rng(SP_SEED), 0,
                                       omega_shard=(c, SP_SHARDS))
                     for c in range(SP_SHARDS)])
    whole = baseline_scenario(spec, np.random.default_rng(SP_SEED), 0)
    made, got = _counted(kernels, lambda: mesh.host_rows(
        make_sample_parallel_solver(spec, mesh)(bufs)))
    assert made == _solves({"K1": SP_SHARDS}, SP_SHARDS), made
    add(made)
    assert mesh.collectives == {"all_gather": 0, "all_reduce": 3}, mesh.collectives
    assert (got == got[0]).all(), "the shards disagree on the winner"
    from kompass_core_tpu_torch.ops.solver import make_packed_dwa_solver

    ref = make_packed_dwa_solver(spec, device)(whole).cpu().numpy()
    assert got[0, 0] == ref[0] == 1.0 and got[0, 2] == ref[2], "found / winner"
    # num_admissible (column 3) counts the winning shard's samples alone
    assert np.array_equal(np.delete(got[0], 3), np.delete(ref, 3)), "winner's output"
    cpu_mesh = FleetMesh(["cpu"] * SP_SHARDS, axis_name="sp")
    cpu = cpu_mesh.host_rows(make_sample_parallel_solver(spec, cpu_mesh)(bufs))
    equal, n_ties = _rows_agree(got, cpu, "sample-parallel card vs CPU")
    log(f"sample-parallel solve: the flagship's {spec.n_omega} omega samples over "
        f"{SP_SHARDS} shards, K1 x {SP_SHARDS}, collectives {mesh.collectives}; "
        f"winner {int(got[0, 2])} cost {got[0, 1]:.6f} == the one-device full window "
        f"(found, winner, cost, trajectory bit for bit); against the CPU port's "
        f"sample-parallel solve: {equal} of {SP_SHARDS} rows bit-equal, winner ties "
        f"{n_ties}")
    return launches


def mesh_worker(device, rank, world, port, out_path):
    """One process of ``phase_mesh_multiprocess``: joins the gloo group on
    ``port``, builds a mesh of one shard on ``device`` (``world`` x 1 shards),
    solves its half of the 128 scenarios and runs MP_TICKS ticks of the
    128-robot peer fleet (the ``xla`` backend) on its own robots, and
    writes its rows, launches and gathers to ``out_path``."""
    import torch

    from kompass_core_tpu_torch.ops import kernels
    from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS
    from kompass_core_tpu_torch.parallel import (
        build_fleet_mesh, initialize_multihost, make_fleet_solver,
    )

    rank, world, device = int(rank), int(world), torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = build_fleet_mesh([device])
    assert (mesh.size, mesh.process_index) == (world, rank), mesh
    spec = baseline_spec("xla")
    bufs = mesh_solver_bufs(spec)
    solved = mesh.host_rows(make_fleet_solver(spec, mesh=mesh)(
        bufs[mesh.local_rows(len(bufs))]))
    fleet, drive = make_peer_fleet(None, "xla", robots=MESH_ROBOTS, mesh=mesh)
    mine = fleet.local_robots
    ticks = []
    for _ in range(MP_TICKS):
        inputs = drive.inputs()
        out = fleet.tick(*inputs[:4], tracked=inputs[4])
        ticks.append(np.stack([out[k].astype(np.float32) for k in OUT_FIELDS], 1))
        # the other process's robots: rows this process never feeds (each
        # robot's state reaches the others through the gather)
        whole = {k: np.zeros((MESH_ROBOTS,) + v.shape[1:], v.dtype)
                 for k, v in out.items()}
        for k, v in out.items():
            whole[k][mine.start:mine.stop] = v
        drive.advance(whole)
    counts = kernels.launch_counts()
    np.savez(out_path, solver=solved, ticks=np.stack(ticks),
             robots=np.array([mine.start, mine.stop]),
             launches=np.array([counts["K1"], counts["K3"]]),
             collectives=np.array([mesh.collectives["all_gather"],
                                   mesh.collectives["all_reduce"]]))
    torch.distributed.destroy_process_group()
    return 0


def phase_mesh_multiprocess(kernels, device):
    """Two processes on the one card (``cuda:0`` each; NCCL refuses two
    ranks on one GPU, so they join a gloo group on a free localhost port:
    the gathered states go through the host), each a mesh of one shard
    (``mesh_worker``): each solves its half of the 128 scenarios and runs
    MP_TICKS ticks of the 128-robot peer fleet on its 64 robots. Their
    rows equal this process's one-device solve and fleet bit for bit;
    each made MP_TICKS gathers. A worker that fails or outlives
    MP_TIMEOUT fails the phase (and both are killed). Returns (the wall
    seconds, the workers' launches per kernel)."""
    import socket

    from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS
    from kompass_core_tpu_torch.parallel import make_fleet_solver

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # the sizes the workers build with (overridden when rehearsed)
    sizes = json.dumps({k: globals()[k] for k in (
        "MESH_ROBOTS", "MP_TICKS", "SAMPLES", "RAYS", "FLEET_SHAPE", "PEER_SHAPE",
        "PEER_ROWS", "BASELINE_SHAPE", "SOLVER_CHUNK")})
    worker_device = str(device) if device.type == "cpu" else "cuda:0"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", MESH_WORKER, sizes, worker_device, str(r),
             str(MP_PROCESSES), str(port), os.path.join(tmp, f"rows_{r}.npz")],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(MP_PROCESSES)]
        try:
            spec = baseline_spec("xla")
            want_solver = make_fleet_solver(spec, device)(mesh_solver_bufs(spec))
            want_solver = want_solver.cpu().numpy()
            one, drive = make_peer_fleet(device, "xla", robots=MESH_ROBOTS)
            want_ticks = []
            for _ in range(MP_TICKS):
                inputs = drive.inputs()
                out = one.tick(*inputs[:4], tracked=inputs[4])
                want_ticks.append(np.stack([out[k].astype(np.float32)
                                            for k in OUT_FIELDS], 1))
                drive.advance(out)
            want_ticks = np.stack(want_ticks)
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=MP_TIMEOUT)[0])
                except subprocess.TimeoutExpired as err:
                    raise AssertionError(f"a mesh worker outlived {MP_TIMEOUT} s") from err
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"mesh worker {r} failed:\n{text[-3000:]}"
        launches = {"K1": 0, "K3": 0}
        for r in range(MP_PROCESSES):
            data = np.load(os.path.join(tmp, f"rows_{r}.npz"))
            lo, hi = (int(v) for v in data["robots"])
            assert (lo, hi) == (r * MESH_ROBOTS // MP_PROCESSES,
                                (r + 1) * MESH_ROBOTS // MP_PROCESSES)
            assert np.array_equal(data["solver"], want_solver[lo:hi]), f"worker {r} solver"
            assert np.array_equal(data["ticks"], want_ticks[:, lo:hi]), f"worker {r} ticks"
            assert data["collectives"].tolist() == [MP_TICKS, 0], data["collectives"]
            assert data["launches"].tolist() == [_chunks(hi - lo), MP_TICKS], (
                data["launches"])
            launches["K1"] += int(data["launches"][0])
            launches["K3"] += int(data["launches"][1])
    log(f"two processes (gloo, {MP_PROCESSES} x 1 shard on {device}): each one's "
        f"{MESH_ROBOTS // MP_PROCESSES} solver rows and {MP_TICKS} peer-fleet ticks == "
        f"this process's one-device results bit for bit, {MP_TICKS} gathers each; "
        f"launches {launches}; wall {wall:.1f} s")
    return wall, launches


def phase_fleet_runtime(kernels, device):
    """``FleetRuntime`` closed loop (``tests/test_fleet_runtime.py``): 32
    Ackermann robots on straight 2.5 m paths over a 2-shard mesh
    ``[cuda, cuda]``, up to RUNTIME_TICKS ticks: every robot reaches its
    goal, no dispatch failed (``solver_failures == 0``: a kernel that
    failed and was retried into a safe stop fails here), K1 once per
    shard per solved tick, no collective. Returns (launches, the host ms
    per tick: median)."""
    from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu_torch.datatypes import LaserScanData
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )
    from kompass_core_tpu_torch.parallel import FleetMesh, FleetRuntime

    robots = [Robot(robot_type=RobotType.ACKERMANN,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.1, 0.4]))
              for _ in range(RUNTIME_ROBOTS)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi),
    )
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            smoothness_weight=0.0, jerk_weight=0.0, obstacles_distance_weight=0.0,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=DT,
    )
    mesh = FleetMesh([device] * MESH_SHARDS)
    runtime = FleetRuntime(robots, limits, config, mesh=mesh)
    paths = []
    for i, robot in enumerate(robots):
        x0 = 0.5 * i
        robot.state.x, robot.state.y, robot.state.yaw = x0, 0.0, np.pi / 2
        paths.append(np.array([[x0, 0.0], [x0, 2.5]]))
    runtime.set_paths(paths)
    scans = [LaserScanData()] * RUNTIME_ROBOTS
    reached = np.zeros(RUNTIME_ROBOTS, bool)
    host_ms, launches, solved = [], {}, 0
    for tick in range(RUNTIME_TICKS):
        made, results = _counted(kernels, lambda: runtime.tick(
            [r.state for r in robots], scans))
        host_ms.append(runtime.last_tick_seconds * 1e3)
        if made:
            assert made == _solves({"K1": MESH_SHARDS}, MESH_SHARDS), (
                f"runtime tick {tick}: {made}")
            solved += 1
        for k, n in made.items():
            launches[k] = launches.get(k, 0) + n
        for i, (robot, res) in enumerate(zip(robots, results)):
            if res.get("reason") == "goal_reached":
                reached[i] = True
                continue
            if res["found"]:
                robot.set_control(velocity_x=res["vx"], velocity_y=res["vy"],
                                  omega=res["omega"])
                robot.get_state(dt=DT)
        if reached.all():
            break
    assert runtime.solver_failures == 0, "a fleet dispatch failed"
    assert reached.all(), f"only {int(reached.sum())}/{RUNTIME_ROBOTS} robots reached"
    assert mesh.collectives == {"all_gather": 0, "all_reduce": 0}
    ms = statistics.median(host_ms)
    log(f"FleetRuntime: {RUNTIME_ROBOTS} robots on {MESH_SHARDS} shards of {device}, "
        f"all reached in {tick + 1} ticks ({solved} solved: K1 x {MESH_SHARDS} each), "
        f"solver_failures 0; host ms per tick median {ms:.3f} (min {min(host_ms):.3f}, "
        f"max {max(host_ms):.3f})")
    return launches, ms


def phase_mesh_times(kernels, device, card, mp_wall, runtime_ms):
    """Times (none a gate): the 128-robot peer fleet's tick on the 2-shard
    mesh against the one device (host clock with syncs, median of
    MESH_TIMED), its k = 8 call per tick eager on the mesh against the one
    device's graph replay (median of MESH_K_TIMED), the same for the
    tracked fleet without peers (a graph per shard), one gather of the
    [64, 7] blocks of two shards alone and its share of the mesh tick,
    the two-process phase's wall seconds and FleetRuntime's host ms per
    tick."""
    import torch

    sharded, one, mesh, drive = _peer_pair(device, "xla")
    inputs = drive.inputs()
    tick_mesh = _median_ms(lambda: sharded.tick(*inputs[:4], tracked=inputs[4]),
                           MESH_TIMED)
    tick_one = _median_ms(lambda: one.tick(*inputs[:4], tracked=inputs[4]), MESH_TIMED)
    one.run_ticks_on_device(TICKS_K, *inputs[:4], tracked=inputs[4])  # capture
    k_mesh = _median_ms(lambda: sharded.run_ticks_on_device(
        TICKS_K, *inputs[:4], tracked=inputs[4]), MESH_K_TIMED)
    k_one = _median_ms(lambda: one.run_ticks_on_device(
        TICKS_K, *inputs[:4], tracked=inputs[4]), MESH_K_TIMED)
    blocks = [torch.zeros(MESH_ROBOTS // MESH_SHARDS, 7, device=device)
              for _ in range(MESH_SHARDS)]
    gather = _median_ms(lambda: mesh.all_gather_rows(blocks), MESH_TIMED)
    del sharded, one
    lane_mesh, lane_one, _, lanes = _lane_pair(device, "xla", FLEET_TRACKED)
    lane_in = lanes.inputs()
    lane_k = []
    for fleet in (lane_mesh, lane_one):
        fleet.run_ticks_on_device(TICKS_K, *lane_in[:4], tracked=lane_in[4])  # capture
        lane_k.append(_median_ms(lambda: fleet.run_ticks_on_device(
            TICKS_K, *lane_in[:4], tracked=lane_in[4]), MESH_K_TIMED)[0] / TICKS_K)
    times = {"tick_mesh_ms": tick_mesh[0], "tick_one_ms": tick_one[0],
             "k8_mesh_ms_per_tick": k_mesh[0] / TICKS_K,
             "k8_one_replay_ms_per_tick": k_one[0] / TICKS_K,
             "k8_tracked_mesh_replay_ms_per_tick": lane_k[0],
             "k8_tracked_one_replay_ms_per_tick": lane_k[1],
             "gather_ms": gather[0], "gather_share": gather[0] / tick_mesh[0],
             "two_process_s": mp_wall, "runtime_host_ms": runtime_ms}
    log(f"mesh times ({card}): peer fleet tick, {MESH_ROBOTS} robots: mesh "
        f"{tick_mesh[0]:.3f} ms (min {tick_mesh[1]:.3f}) vs one device "
        f"{tick_one[0]:.3f} ms (min {tick_one[1]:.3f}); k={TICKS_K} per tick: mesh "
        f"eager {k_mesh[0] / TICKS_K:.3f} ms vs one-device replay "
        f"{k_one[0] / TICKS_K:.3f} ms; the tracked fleet without peers, k={TICKS_K} "
        f"per tick: a graph per shard {lane_k[0]:.3f} ms vs one device {lane_k[1]:.3f} "
        f"ms; gather of {MESH_SHARDS} x "
        f"[{MESH_ROBOTS // MESH_SHARDS}, 7] {gather[0]:.4f} ms, "
        f"{100 * times['gather_share']:.2f}% of the mesh tick; two-process phase "
        f"{mp_wall:.1f} s wall; FleetRuntime {runtime_ms:.3f} host ms per tick")
    log("mesh times json: " + json.dumps(times))
    torch.cuda.empty_cache()
    return times


# --- the reference's recordings ---------------------------------------------

RECORDED = "tests/resources/reference"
RECORDED_START = (-0.51731912, 0.0, math.pi / 2)  # the reference's run_control
RECORDED_STEPS = 100  # command applications, as the reference allows
RECORDED_DT = 0.1


def recorded_path(name="global_path.json"):
    """The reference's recorded ROS global plan as [N, 2] points."""
    with open(os.path.join(RECORDED, "control", name)) as f:
        poses = json.load(f)["poses"]
    return np.array([[p["pose"]["position"]["x"], p["pose"]["position"]["y"]]
                     for p in poses])


def recorded_scan():
    from kompass_core_tpu_torch.datatypes import LaserScanData

    with open(os.path.join(RECORDED, "mapping", "laserscan_data.json")) as f:
        d = json.load(f)
    return LaserScanData(angle_min=d["angle_min"], angle_max=d["angle_max"],
                         angle_increment=d["angle_increment"],
                         range_min=d["range_min"], range_max=d["range_max"],
                         ranges=np.asarray(d["ranges"], np.float64))


def recorded_cloud():
    from kompass_core_tpu_torch.datatypes import PointCloudData

    with open(os.path.join(RECORDED, "mapping", "livox_pointcloud_sample_1.json")) as f:
        d = json.load(f)
    fields = {fl["name"]: fl for fl in d["fields"]}
    return PointCloudData.from_bytes(
        bytes(d["data"]), point_step=d["point_step"], x_offset=fields["x"]["offset"],
        y_offset=fields["y"]["offset"], z_offset=fields["z"]["offset"],
        dtype_code=fields["x"]["datatype"], row_step=d["row_step"], height=d["height"])


def _recorded_dwa(device):
    """``test_reference_fixtures.py``'s DWA on the recorded path: an
    Ackermann cylinder, 4 x 4 samples, path weight 3, goal weight 1."""
    from kompass_core_tpu_torch.control import DWA, DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits, RobotGeometry,
        RobotType,
    )

    robot = Robot(robot_type=RobotType.ACKERMANN,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.1, 0.4]))
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi))
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4, octree_resolution=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            smoothness_weight=0.0, jerk_weight=0.0, obstacles_distance_weight=0.0),
        prediction_horizon=10, control_horizon=2, control_time_step=RECORDED_DT,
        max_num_threads=1)
    dwa = DWA(robot=robot, ctrl_limits=limits, config=config, device=device)
    dwa.set_path(recorded_path())
    robot.state.x, robot.state.y, robot.state.yaw = RECORDED_START
    return robot, dwa


def _recorded_mapper(device, what):
    """The mapper of ``test_reference_fixtures.py`` (``"scan"``,
    ``"cloud"``) or ``test_mapping.py``'s empty-cloud test (``"empty"``)."""
    from kompass_core_tpu_torch.datatypes import ScanModelConfig
    from kompass_core_tpu_torch.mapping import LocalMapper, MapConfig

    config, model = {
        "scan": (MapConfig(width=10.0, height=10.0, resolution=0.05),
                 ScanModelConfig(angle_step=recorded_scan().angle_increment)),
        "cloud": (MapConfig(width=10.0, height=10.0, resolution=0.1),
                  ScanModelConfig(angle_step=np.deg2rad(1.0), max_height=2.0,
                                  min_height=-0.2)),
        "empty": (MapConfig(width=6.0, height=6.0, resolution=0.1),
                  ScanModelConfig(p_prior=0.5, angle_step=2 * np.pi / 72)),
    }[what]
    return LocalMapper(config, model, device=device)


def phase_recorded(kernels, device):
    """The reference's recordings on the card, as the JAX package's own
    tests assert them (``test_reference_fixtures.py``,
    ``test_mapping.py``): the Ackermann DWA follows the recorded global
    plan to its end (each solve launches K1 once and equals the CPU's),
    the recorded 360-ray scan and the recorded Livox frame go through
    ``LocalMapper`` and an empty cloud leaves no occupied cell (K5 once
    each, every layer equal to the CPU mapper's). Returns the launches."""
    from kompass_core_tpu_torch.datatypes import LaserScanData, PointCloudData, PoseData

    t0 = time.perf_counter()
    _zero_launches(kernels)
    robot, dwa = _recorded_dwa(device)
    cpu_ties, solves, steps, reached = [], 0, 0, False
    while not reached and steps < RECORDED_STEPS:
        before = kernels.fused_min_dist_sq.launches
        ok = dwa.loop_step(current_state=robot.state, laser_scan=LaserScanData())
        made = kernels.fused_min_dist_sq.launches - before
        assert made == int(ok), f"step {steps}: {made} K1 launches, loop_step {ok}"
        if not ok or not dwa.path:
            reached = dwa.reached_end()
            break
        solves += 1
        _cpu_check(*dwa.last_solver_io, cpu_ties)
        for vx, vy, omega in zip(np.atleast_1d(dwa.linear_x_control),
                                 np.atleast_1d(dwa.linear_y_control),
                                 np.atleast_1d(dwa.angular_control)):
            robot.set_control(velocity_x=vx, velocity_y=vy, omega=omega)
            robot.get_state(dt=RECORDED_DT)
            steps += 1
            reached = dwa.reached_end()
    assert reached, f"the recorded path's end was not reached in {steps} steps"
    log(f"recorded path: end reached after {steps} steps and {solves} solves, "
        f"robot at ({robot.state.x:.3f}, {robot.state.y:.3f}); CPU ties {cpu_ties}")

    counts = {}
    for what, scan in (("scan", recorded_scan()), ("cloud", recorded_cloud()),
                       ("empty", PointCloudData(points=np.zeros((0, 3), np.float32)))):
        mapper = _recorded_mapper(device, what)
        state = _mapper_state(mapper)
        before = kernels.scan_to_grid_cells.launches
        mapper.update_from_scan(PoseData(), scan)
        assert kernels.scan_to_grid_cells.launches == before + 1, what
        n_diff = _mapper_cpu_check(mapper, state, PoseData(), scan, f"recorded {what}")
        occ = mapper.occupancy
        counts[what] = (int((occ == 100).sum()), int((occ == 0).sum()), n_diff)
    (scan_occ, scan_empty, _), (cloud_occ, cloud_empty, _), (empty_occ, _, _) = (
        counts["scan"], counts["cloud"], counts["empty"])
    assert scan_occ > 50 and scan_empty > 2000, counts["scan"]
    assert cloud_occ > 0 and cloud_empty > 0, counts["cloud"]
    assert empty_occ == 0, counts["empty"]
    launches = _launches_made(kernels, {k: 0 for k in kernels.launch_counts()})
    assert launches == _solves({"K1": solves, "K5": 3}, solves), launches
    log(f"recorded mapper updates (occupied, empty cells, beams whose table "
        f"differs from the CPU's): {counts}; launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# the benchmark runner's nine workloads in run_all's order, each with the
# kernel it launches once per dispatch on the card
BENCH_WORKLOADS = (("DWA_2025x30", "K1"), ("DWA_LargeBatch_65k", "K1"),
                   ("DWA_Fleet_64", "K1"), ("CostEvaluator_5k_Trajs", "K1"),
                   ("Mapper_Dense_400x400", "K5"), ("Mapper_Bayesian_400x400", "K5"),
                   ("Mapper_PointCloud_100k", "K5"), ("CriticalZone_100k_Cloud", None),
                   ("CriticalZone_Dense_Scan", None))
BENCH_RECORD_KEYS = {"name", "runs", "mean_ms", "min_ms", "p50_ms", "p99_ms", "method"}
BENCH_LARGE = (255, 255, 30, 512, 384)  # DWA_LargeBatch_65k: samples per axis, steps, rows
BENCH_LOOP_KS = (4, 12)  # the device loop's two chain lengths
BENCH_LOOP_REPEATS = 1


def _recorded_k1(kernels, fn):
    """(what ``fn()`` returned, the one K1 call it made: (its arguments,
    its outputs)), K1 reached through the solver's module as a solve
    reaches it."""
    from kompass_core_tpu_torch.ops import solver as tsolver

    calls = []
    launch = tsolver.fused_min_dist_sq

    def record(*args, **kw):
        out = launch(*args, **kw)
        calls.append((args, out))
        return out

    tsolver.fused_min_dist_sq = record
    try:
        out = fn()
    finally:
        tsolver.fused_min_dist_sq = launch
    assert len(calls) == 1, f"{len(calls)} K1 calls"
    return out, calls[0]


def phase_benchmark(kernels, device, card):
    """Phase 41: the benchmark layer on the card. ``BenchmarkRunner.run_all``
    once: each record's schema and a finite, positive p50; each DWA
    workload and the evaluator launch K1 and each mapper workload K5
    exactly once per dispatch; then the DWA device loop (K = 4 and 12, one
    repeat). Then the comparisons: one DWA_2025x30 variant against the
    CPU port, K1's call of one DWA_LargeBatch_65k solve against its plain
    version bit for bit, and the device loop's replayed final cost against
    the same chain run eagerly on the card, bit for bit. Returns (the
    main-path launches by kernel, K1's max abs difference)."""
    import torch

    from kompass_core_tpu_torch.benchmark import device_loop
    from kompass_core_tpu_torch.benchmark.runner import (
        BenchmarkRunner,
        slope_variants_needed,
    )
    from kompass_core_tpu_torch.ops.solver import get_packed_dwa_solver

    t0 = time.perf_counter()
    _zero_launches(kernels)
    runner = BenchmarkRunner(device)
    made = {}

    def counted(bench):
        def run():
            before, n = kernels.launch_counts(), len(runner.results)
            bench()
            (rec,) = runner.results[n:]
            made[rec["name"]] = _launches_made(kernels, before)
        return run

    for attr in [a for a in dir(runner) if a.startswith("bench_")]:
        setattr(runner, attr, counted(getattr(runner, attr)))
    records = runner.run_all()
    assert runner.platform == "cuda_" + torch.cuda.get_device_name(0).replace(" ", "_")
    assert [r["name"] for r in records] == [n for n, _ in BENCH_WORKLOADS], records
    dispatches = slope_variants_needed()
    for rec, (name, key) in zip(records, BENCH_WORKLOADS):
        assert BENCH_RECORD_KEYS <= set(rec), rec
        assert math.isfinite(rec["p50_ms"]) and rec["p50_ms"] > 1e-9, rec
        want = {} if key is None else {key: dispatches}
        assert made[name] == (_solves(want, dispatches) if key == "K1" else want), (
            name, made[name])
        log(f"benchmark record ({card}): {json.dumps(rec)}; launches {made[name]}")
    launches = {key: sum(m.get(key, 0) for m in made.values()) for key in ("K1", "K5", "K10")}

    loops = {}
    spec, variants = device_loop._dwa_baseline_buffers(2 * BENCH_LOOP_REPEATS + 2, device)
    before = kernels.launch_counts()
    rec = device_loop.measure_device_loop(
        "DWA_2025x30_device_loop",
        lambda k: loops.setdefault(k, device_loop.make_dwa_device_loop(spec, k, device)),
        variants, ks=BENCH_LOOP_KS, repeats=BENCH_LOOP_REPEATS)
    # the wrapper counts the capture's warm-up (run) and its capture (not
    # run); a replay calls no wrapper: the card ran each K's warm-up and K
    # per replay (one warm-up dispatch and one per repeat)
    wrapped = _launches_made(kernels, before)
    assert wrapped == _solves({"K1": 2 * sum(BENCH_LOOP_KS)}, 2 * sum(BENCH_LOOP_KS)), wrapped
    assert {k: c for k, c in kernels.launch_counts().items() if c} == {
        "K1": launches["K1"] + wrapped["K1"], "K5": launches["K5"],
        "K10": launches["K10"] + wrapped["K10"]}
    loop_launches = sum(BENCH_LOOP_KS) * (2 + BENCH_LOOP_REPEATS)
    launches["K1"] += loop_launches
    launches["K10"] += loop_launches
    assert math.isfinite(rec["p50_ms"]), rec
    assert rec["method"] == "device_loop_k{}_k{}".format(*BENCH_LOOP_KS), rec
    log(f"benchmark record ({card}): {json.dumps(rec)}; launches {{'K1': {loop_launches}}}")

    # the comparisons (their launches are not the main path's)
    k = max(BENCH_LOOP_KS)
    replay = loops[k](variants[0])
    eager = device_loop.dwa_chain(spec, k)(variants[0])
    assert torch.equal(replay, eager), f"device loop replay {replay} != eager {eager}"
    out = get_packed_dwa_solver(spec, device)(variants[0]).cpu().numpy()
    ties = []
    _cpu_check(spec, variants[0].cpu().numpy(), out, ties)
    solver, large = runner._dwa_workload(*BENCH_LARGE, "large")
    out, (args, fields) = _recorded_k1(kernels, lambda: solver(large[0]))
    assert args[0].shape[-2:] == (BENCH_LARGE[0] * BENCH_LARGE[1], BENCH_LARGE[2]), (
        args[0].shape)
    # the plain version sweeps in slabs of samples (kernels._sweep_reference):
    # the 65025 x 30 x 896 pairs (7 GB at once) never materialise
    err = _check_equal("K1 at DWA_LargeBatch_65k", fields,
                       kernels.fused_min_dist_sq_reference(*args))
    assert bool(out[0] > 0.5) and math.isfinite(float(out[1])), out[:4]
    log(f"benchmark checks ({card}): the device loop's K = {k} replay == its eager chain "
        f"on the card ({float(replay):.6f}); DWA_2025x30 variant 0 agrees with the CPU "
        f"port (ties {ties}); K1 at DWA_LargeBatch_65k ({args[0].shape[-2]} x "
        f"{args[0].shape[-1]} vs {args[2].shape[-2]} + {args[3].shape[-1]} rows) == plain "
        f"bit for bit; launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches, err


# --- the benchmark tools (phase 42) ------------------------------------------
# the last five modules of benchmark/, at the sizes their own entries run
# (the full sweeps and timings are theirs: python -m
# kompass_core_tpu_torch.benchmark.<module> --device cuda)

TOOLS_SHARDS = 2  # scaling_proof's mesh: [cuda, cuda]
CLIFF_BATCHES = (64, 80)  # batch_cliff.sweep's batches, K and repeats here
CLIFF_KS = (4, 12)
CLIFF_REPEATS = 1
CHUNK_ROBOTS = 1024  # chunk_unroll_bench's fleet: 1024 robots, 512 rays
CHUNK_RAYS = 512
CHUNK_BLOCK = 64  # the JAX tick's block
CHUNK_REPLAYS = 3  # replays of each captured tick, one distinct input each
CHUNK_CPU_ROWS = (0, 511, 1023)
SPLIT_KS = (4, 12)  # mapper_split's device loops, K and repeats here
SPLIT_REPEATS = 3


def _replayed_tick(kernels, fleet, block, inputs, device):
    """(the CUDA graph of the chunk bench's tick (``block`` rows at a time,
    None for the whole axis), its outputs after each replay on ``inputs``,
    ms per replay by CUDA events, wrapper launches, card launches)."""
    import torch

    from kompass_core_tpu_torch.benchmark import chunk_unroll_bench as cb

    before = kernels.launch_counts()
    run = cb.graphed(cb.tick_fn(fleet, block), inputs[0], device)
    wrapped = _launches_made(kernels, before)
    outs = []
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for x in inputs:
        start.record()
        carry, out = run(x)
        stop.record()
        torch.cuda.synchronize()
        outs.append(((*(t.clone() for t in carry), out.clone()), start.elapsed_time(stop)))
    assert _launches_made(kernels, before) == wrapped, "a replay called a wrapper"
    # the wrappers counted the capture's warm-up (run) and its capture (not
    # run); each replay runs the captured launches once more
    per_tick = {k: n // 2 for k, n in wrapped.items()}
    card = {k: n * (1 + len(inputs)) for k, n in per_tick.items()}
    return run, outs, card, per_tick


def phase_benchmark_tools(kernels, device, card):
    """Phase 42: the five benchmark tools on the card. ``scaling_proof.
    build_proof`` over ``[cuda, cuda]`` (the seven collective counts);
    ``batch_cliff.sweep`` at batches 64 and 80, K = 4 and 12, one repeat
    (one CUDA graph per batch and K; the wrappers count one K1 per solve
    of each capture's warm-up and capture, a replay none); the chunk
    bench's 1024-robot fleet, its tick captured whole and in 64-row
    blocks, 3 replays each: blocked == whole bit for bit, rows 0, 511 and
    1023 against a 3-robot fleet of those robots on the CPU, the peak
    memory; ``mapper_split.main`` (3 turns of slopes, device loops at K
    = 4 and 12) and ``shootout`` (the update through K5 == through its
    plain version).
    Returns (the main-path launches by kernel, read from the wrappers and
    the replays)."""
    import torch

    from kompass_core_tpu_torch.benchmark import (
        batch_cliff,
        chunk_unroll_bench,
        mapper_split,
        scaling_proof,
    )
    from kompass_core_tpu_torch.parallel import FleetMesh

    t0 = time.perf_counter()
    launches = {}

    def add(made):
        for key, n in made.items():
            launches[key] = launches.get(key, 0) + n

    made, proof = _counted(kernels, lambda: scaling_proof.build_proof(
        FleetMesh([device] * TOOLS_SHARDS)))
    add(made)
    counts = {k: v["collective_counts"] for k, v in proof["programs"].items()}
    assert counts["fleet_v2_tick_peers_mesh"] == {"all-gather": 1}, counts
    assert counts["sample_parallel_solver"] == {"all-reduce": 3}, counts
    assert all(not counts[k] for k in scaling_proof.STEADY_STATE), counts
    assert {"K1", "K3", "K3s"} <= set(made), made
    log(f"scaling proof over {TOOLS_SHARDS} shards on the card: {json.dumps(counts)}; "
        f"launches {made}")

    made, rows = _counted(kernels, lambda: batch_cliff.sweep(
        device, batches=CLIFF_BATCHES, ks=CLIFF_KS, repeats=CLIFF_REPEATS))
    # per batch and K: the capture's warm-up and its capture (K each); the
    # card also ran the first dispatch's replay and one per repeat
    n = 2 * sum(CLIFF_KS) * len(CLIFF_BATCHES)
    assert made == _solves({"K1": n}, n), made
    cliff = sum(CLIFF_KS) * (2 + CLIFF_REPEATS) * len(CLIFF_BATCHES)
    add({"K1": cliff, "K10": cliff})
    for rec in rows:
        assert math.isfinite(rec["us_per_solve"]) and rec["us_per_solve"] > 0, rec
        log(f"batch cliff ({card}): batch {rec['batch']}: {rec['us_per_solve']:.3f} us "
            f"per solve (K = {CLIFF_KS}), capture {rec['compile_s']:.2f} s")
    log(f"batch cliff launches: {cliff} K1 on the card ({made['K1']} wrapper calls)")

    fleet = chunk_unroll_bench._setup_fleet(CHUNK_ROBOTS, CHUNK_RAYS, device=device)
    inputs = [torch.from_numpy(v).to(device)
              for v in chunk_unroll_bench.tick_inputs(fleet, CHUNK_REPLAYS)]
    torch.cuda.synchronize()
    results = {}
    for label, block in (("whole", None), (f"blocks of {CHUNK_BLOCK}", CHUNK_BLOCK)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        run, outs, made, per_tick = _replayed_tick(kernels, fleet, block, inputs, device)
        peak = torch.cuda.max_memory_allocated(device) / 2**20
        n = 1 if block is None else CHUNK_ROBOTS // CHUNK_BLOCK
        assert per_tick == _solves({"K1": n}, n), (
            label, per_tick)
        add(made)
        results[label] = outs
        ms = [t for _, t in outs]
        log(f"1024-robot tick, {label} ({card}): {statistics.mean(ms):.4f} ms per replay "
            f"by events {[round(t, 4) for t in ms]}, {statistics.mean(ms) / CHUNK_ROBOTS * 1e3:.3f} "
            f"us per robot; peak {peak:.1f} MiB allocated; launches {made}")
        del run
    for (w, _), (b, _) in zip(results["whole"], results[f"blocks of {CHUNK_BLOCK}"]):
        for x, y in zip(w, b):
            assert torch.equal(x, y), "the blocked tick differs from the whole tick"
    whole = results["whole"][0][0]
    checked = chunk_unroll_bench.check(
        fleet, inputs[0], CHUNK_BLOCK, CHUNK_CPU_ROWS,
        whole=(whole[:-1], whole[-1]),
        blocked=(results[f"blocks of {CHUNK_BLOCK}"][0][0][:-1],
                 results[f"blocks of {CHUNK_BLOCK}"][0][0][-1]))
    found = int(whole[-1][:, 0].sum().item())
    log(f"1024-robot tick: blocked == whole bit for bit on {CHUNK_REPLAYS} inputs; rows "
        f"{checked['rows']} agree with a {len(CHUNK_CPU_ROWS)}-robot fleet on the CPU "
        f"(ties {checked['ties']}); {found} of {CHUNK_ROBOTS} found")
    del fleet, inputs, results, whole
    torch.cuda.empty_cache()

    made, split = _counted(kernels, lambda: mapper_split.main(
        device, repeats=SPLIT_REPEATS, ks=SPLIT_KS))
    # one K5 per dispatch of the cell pass's and the whole update's slopes
    # (each measured SPLIT_REPEATS times); two K5 device loops (the cell
    # pass, the whole update): per K the wrappers counted the warm-up and
    # the capture, the card ran the warm-up, the first replay and one per
    # repeat
    assert made == {"K5": 2 * SPLIT_REPEATS * slope_variants_needed()
                    + 2 * 2 * sum(SPLIT_KS)}, made
    add({"K5": made["K5"] + 2 * sum(SPLIT_KS) * SPLIT_REPEATS})
    log(f"mapper split ({card}): {json.dumps(split)}; launches {made} (wrapper calls)")
    made, shoot = _counted(kernels, lambda: mapper_split.shootout(device))
    assert made == {"K5": 1 + slope_variants_needed()}, made
    add(made)
    log(f"mapper shoot-out ({card}): K5 == plain on one input (checksum "
        f"{shoot['checksum']}); k5 {shoot['k5']:.4f} ms, plain {shoot['plain']:.4f} ms per "
        f"update (slope)")
    log(f"benchmark tools: launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


# the README's workflows (examples_torch/) at the README's sizes
EXAMPLE_LANE_ROBOTS = 100  # `fleet_demo.py 100`
EXAMPLE_PEER_ROBOTS = 8  # the peer, prediction, mesh and host modes
EXAMPLE_FLEET_MODES = (("host", {"host_mode": True}), ("peers", {"peers": True}),
                       ("predict", {"predict": True}), ("mesh", {"mesh": True}))
EXAMPLE_RTT_KS = (1, 8)
# the aot demo's figures that name the file, the torch build or the device
EXAMPLE_AOT_DEVICE_FIGURES = ("path", "size_kb", "torch", "platforms")
EXAMPLE_CLI_TIMEOUT = 300  # seconds for `python examples_torch/full_stack_demo.py`


@contextlib.contextmanager
def _solves_checked(ties):
    """Every ``DWA`` solve inside the block held against the port's CPU
    solve of the same packed input (``_cpu_check``: phase 4's rule).
    Yields the list of faults: ``loop_step`` swallows exceptions, so a
    fault is kept there rather than raised in the solve."""
    from kompass_core_tpu_torch.control import DWA

    original = DWA.compute_velocity_commands
    faults = []

    def checked(self, *args, **kwargs):
        before = self._last_solver_io
        result = original(self, *args, **kwargs)
        io = self._last_solver_io
        if io is not None and io is not before:
            try:
                _cpu_check(*io, ties)
            except AssertionError as e:
                faults.append(str(e))
        return result

    DWA.compute_velocity_commands = checked
    try:
        yield faults
    finally:
        DWA.compute_velocity_commands = original


def _same_as_printed(mod, card_fig, cpu_fig, skip=()):
    """The card's outcome lines (``mod.lines``) equal the port's CPU run's,
    the figures in ``skip`` taken from the CPU's."""
    got = mod.lines({**card_fig, **{k: cpu_fig[k] for k in skip}})
    want = mod.lines(cpu_fig)
    assert got == want, f"{mod.__name__}: card {got} != CPU {want}"


def phase_examples(kernels, device, card):
    """Phase 43: the README's nine workflows (``examples_torch/``), each
    ``run(cuda, ...)`` at its README size with the JAX demo's own
    assertions: the full stack on the CPU's PRM plan (every solve against
    the CPU's, then card == CPU as printed), the dynamic world likewise,
    ``fleet_demo`` at 100 robots in lanes and at 8 in the host, peer,
    prediction and mesh modes (card == CPU as printed), the RTT serving at
    k = 1 and 8 and the AOT artifact (card == CPU as printed), the serving
    restart and the artifact sharded over 4 shards of the card (each
    bit-identical on the card), the vision and offline host workflows (no
    launch); then ``python examples_torch/full_stack_demo.py`` with no
    arguments, which plans on the card by default.
    Returns the launches by kernel that the card ran: the wrapper calls of
    the card runs, less each fleet graph's recording, plus its replays
    (``_card_runs``)."""
    import importlib

    t0 = time.perf_counter()
    launches, report = {}, {}

    def demo(name):
        return importlib.import_module(f"examples_torch.{name}")

    def on_card(label, fn, expect):
        start = time.perf_counter()
        with _fleet_graphs() as graphs:
            made, fig = _counted(kernels, fn)
        wall = time.perf_counter() - start
        assert set(made) == set(expect) and all(made.values()), (label, made)
        ran = _card_runs(made, graphs)
        for key, n in ran.items():
            launches[key] = launches.get(key, 0) + n
        report[label] = {"wall_s": round(wall, 3), "launches": ran, "wrapper_calls": made,
                         "fleet_graphs": len(graphs)}
        log(f"workflow {label} on the card ({card}): {wall:.2f} s, wrapper calls {made}, "
            f"{len(graphs)} fleet graphs, launches {ran}")
        return fig

    full = demo("full_stack_demo")
    plan, _ = full.plan("cpu")
    ties = []
    with _solves_checked(ties) as faults:
        card_fig = on_card("full stack", lambda: full.run(device, plan_path=plan),
                           ("K1", "K5", "K10"))
    assert not faults, faults
    _same_as_printed(full, card_fig, full.run("cpu", plan_path=plan))
    log(f"full stack on the CPU's plan: {full.lines(card_fig)}; CPU ties {ties}")

    world = demo("dynamic_world_demo")
    ties = []
    with _solves_checked(ties) as faults:
        card_fig = on_card("dynamic world", lambda: world.run(device), ("K3", "K10"))
    assert not faults, faults
    _same_as_printed(world, card_fig, world.run("cpu"))
    log(f"dynamic world: {world.lines(card_fig)[-1]}; CPU ties {ties}")

    fleet = demo("fleet_demo")
    timings = {}
    card_fig = on_card("fleet lanes", lambda: fleet.run(
        device, EXAMPLE_LANE_ROBOTS, timings=timings), ("K1", "K10"))
    # one tick graph: its capture's two wrapper calls, and on the card its
    # warm-up and one replay a tick
    lanes = report["fleet lanes"]
    assert lanes["wrapper_calls"]["K1"] == 2 and lanes["fleet_graphs"] == 1, lanes
    assert card_fig["ticks"] + 1 == lanes["launches"]["K1"], card_fig
    steady = timings["steady_tick_s"] * 1e3
    report["fleet lanes"]["steady_tick_ms"] = steady
    log(f"fleet demo ({card}): {fleet.lines(card_fig)[0]}; steady tick {steady:.3f} ms")
    for mode, kw in EXAMPLE_FLEET_MODES:
        card_fig = on_card(f"fleet {mode}", lambda: fleet.run(
            device, EXAMPLE_PEER_ROBOTS, **kw),
            ("K3", "K10") if mode == "predict" else ("K1", "K10"))
        _same_as_printed(fleet, card_fig, fleet.run("cpu", EXAMPLE_PEER_ROBOTS, **kw))
        log(f"fleet demo: {fleet.lines(card_fig)[0]}")

    rtt = demo("rtt_amortized_serving_demo")
    for k in EXAMPLE_RTT_KS:
        timings = {}
        card_fig = on_card(f"rtt k={k}", lambda: rtt.run(device, k, timings=timings),
                           ("K1", "K10"))
        # the wrappers counted the warm-up and the capture of the tick's
        # graph and of the k-tick loop's; the card ran each warm-up and one
        # replay per call (1 + N_SINGLE ticks, 1 + N_BATCHES k-tick calls)
        wrapped, made = (report[f"rtt k={k}"][key] for key in ("wrapper_calls", "launches"))
        assert wrapped == _solves({"K1": 2 + 2 * k}, 2 + 2 * k), wrapped
        n = 2 + rtt.N_SINGLE + 2 * k + k * rtt.N_BATCHES
        assert made == _solves({"K1": n}, n), made
        _same_as_printed(rtt, card_fig, rtt.run("cpu", k))
        report[f"rtt k={k}"].update(timings)
        log(f"rtt serving ({card}): single tick {timings['single_ms']:.3f} ms, k = {k} "
            f"{timings['k_ms']:.3f} ms per tick; {rtt.lines(card_fig)[0]}; launches "
            f"{made} (the replays' included)")

    aot = demo("aot_artifact_demo")
    timings = {}
    card_fig = on_card("aot", lambda: aot.run(device, timings=timings), ("K1", "K10"))
    _same_as_printed(aot, card_fig, aot.run("cpu"), EXAMPLE_AOT_DEVICE_FIGURES)
    report["aot"].update(timings)
    log(f"aot artifact ({card}): {aot.lines(card_fig)}; served solve "
        f"{timings['served_solve_ms']:.3f} ms (median of {aot.SERVE_TIMED})")

    for name in ("serving_restart_demo", "serving_mesh_shard_demo"):
        mod = demo(name)
        card_fig = on_card(name, lambda: mod.run(device), ("K1", "K10"))
        log(f"{name}: {mod.lines(card_fig)}")
    for name in ("vision_follow_demo", "offline_pipeline_demo"):
        mod = demo(name)
        with tempfile.TemporaryDirectory() as tmp:
            on_card(name, lambda: mod.run(tmp) if name == "offline_pipeline_demo"
                    else mod.run(), ())
        log(f"{name} (host): passed")

    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "examples_torch/full_stack_demo.py"],
                          capture_output=True, text=True, timeout=EXAMPLE_CLI_TIMEOUT,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FULL STACK DEMO PASSED" in proc.stdout, proc.stdout
    report["full stack command"] = {"wall_s": round(time.perf_counter() - start, 3)}
    log(f"python examples_torch/full_stack_demo.py (on the card by default, {card}): "
        f"{proc.stdout.strip().splitlines()}")
    log(json.dumps({"workflows": report}))
    log(f"workflows: launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


# phase 44: the card's twins of the JAX package's own tests, as the card
# runs them; CARD_TWIN_LEFT_OUT: test names deselected here, each with its
# reason (PERF.md lists them)
CARD_TWIN_FILES = ("tests/test_torch_twin_cuda.py", "tests/test_torch_twin_cuda_main.py")
CARD_TWIN_LEFT_OUT = (
    # the 28 reference planner ids on the turtlebot map: phase 27 solves
    # each id on the card
    "test_planner_solves_turtlebot_map",
    # the serving file's 17 tests, over the budget (88 s of torch.export
    # traces and fresh processes on the card): phases 31-34 serve on the card
    "Test_serving_export",
)
CARD_TWIN_BUDGET_S = 150.0
# every kernel the twinned files reach on the card
CARD_TWIN_KERNELS = ("K1", "K2", "K3", "K3s", "K5", "K6", "K7", "K8", "K9", "K10")


class _TwinReport:
    """A pytest plugin: each card twin's outcome and seconds by the JAX
    file it twins (its class in the main file, else its twin file)."""

    def __init__(self):
        self.outcomes, self.seconds = {}, {}

    @staticmethod
    def group(nodeid):
        path, _, rest = nodeid.partition("::")
        head = rest.split("::")[0]
        return head if head.startswith("Test_") else os.path.basename(path)

    def pytest_runtest_logreport(self, report):
        group = self.group(report.nodeid)
        self.seconds[group] = self.seconds.get(group, 0.0) + report.duration
        if report.when == "call" or report.outcome != "passed":
            outcomes = self.outcomes.setdefault(group, {})
            outcome = "error" if report.failed and report.when != "call" else report.outcome
            outcomes.setdefault(report.nodeid, outcome)
            if outcome != "passed":
                outcomes[report.nodeid] = outcome


def phase_card_twins(kernels, card):
    """Phase 44: the card twins of the JAX package's own tests
    (``tests/test_torch_twin_cuda.py``, ``tests/test_torch_twin_cuda_main.py``)
    in this process through ``pytest.main`` with ``--noconftest -m cuda``,
    but CARD_TWIN_LEFT_OUT. Fails when pytest returns non-zero, when any
    test fails or skips (on the card a skip is a hidden failure), when a
    kernel of CARD_TWIN_KERNELS did not launch, or past CARD_TWIN_BUDGET_S.
    Prints the passes and seconds per twinned file. Returns the launches
    by kernel (wrapper calls; a captured graph's replays launch without
    one, so the k-tick tests' replays are not counted)."""
    import pytest

    root = os.path.dirname(os.path.abspath(__file__))
    tests = os.path.join(root, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    _zero_launches(kernels)
    report = _TwinReport()
    t0 = time.perf_counter()
    rc = pytest.main([*(os.path.join(root, f) for f in CARD_TWIN_FILES),
                      "--noconftest", "-m", "cuda", "-q", "-p", "no:cacheprovider",
                      "--rootdir", root,
                      "-k", " and ".join(f"not {name}" for name in CARD_TWIN_LEFT_OUT)],
                     plugins=[report])
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in kernels.launch_counts().items() if n}
    bad = {nodeid: outcome for outcomes in report.outcomes.values()
           for nodeid, outcome in outcomes.items() if outcome != "passed"}
    for group in sorted(report.outcomes):
        outcomes = report.outcomes[group].values()
        log(f"card twins {group}: {sum(o == 'passed' for o in outcomes)} of "
            f"{len(outcomes)} passed in {report.seconds[group]:.2f} s")
    passed = sum(o == "passed" for g in report.outcomes.values() for o in g.values())
    log(f"card twins ({card}): {passed} passed, {len(bad)} not, pytest exit {int(rc)}, "
        f"{wall:.1f} s; wrapper launches {launches}; left out "
        f"{list(CARD_TWIN_LEFT_OUT)}")
    assert int(rc) == 0 and not bad and passed, (int(rc), bad)
    assert all(launches.get(key) for key in CARD_TWIN_KERNELS), launches
    assert wall <= CARD_TWIN_BUDGET_S, f"card twins took {wall:.1f} s"
    return launches


def _elapsed(t_start, name):
    """The script's seconds so far, after phase ``name``."""
    log(f"elapsed after {name}: {time.perf_counter() - t_start:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs only on a GPU",
              file=sys.stderr)
        return 2
    from kompass_core_tpu_torch.ops import kernels

    device = torch.device("cuda")
    t_start = time.perf_counter()
    phase_environment(kernels)
    _elapsed(t_start, "environment")
    card = card_line()
    phase_build(kernels)
    _elapsed(t_start, "build")
    k1_err = max(phase_kernel_vs_plain(kernels, device),
                 phase_batched_k1(kernels, device))
    _elapsed(t_start, "kernel_vs_plain")
    k3_err = phase_moving_vs_plain(kernels, device)
    _elapsed(t_start, "moving_vs_plain")
    slice_launches = phase_slice(kernels, device)
    _elapsed(t_start, "slice")
    fleet_launches = phase_fleet(kernels, device)
    _elapsed(t_start, "fleet")
    k5_err = phase_mapper_kernel_vs_plain(kernels, device)
    _elapsed(t_start, "mapper_kernel_vs_plain")
    kernels.fused_min_dist_sq.launches = 0
    kernels.fused_min_dist_sq_moving.launches = 0
    kernels.scan_to_grid_cells.launches = 0
    phase_mapping(kernels, device)
    _elapsed(t_start, "mapping")
    k5_launches = kernels.scan_to_grid_cells.launches
    assert kernels.fused_min_dist_sq.launches == 0
    assert kernels.fused_min_dist_sq_moving.launches == 0
    k2_err, k4_err = phase_expanded_vs_plain(kernels, device)
    _elapsed(t_start, "expanded_vs_plain")
    _zero_launches(kernels)
    phase_fleet_solver(kernels, device)
    _elapsed(t_start, "fleet_solver")
    k2_launches = kernels.fused_min_dist_sq_expanded.launches
    k4_launches = kernels.min_dist_sq_expanded.launches
    assert kernels.fused_min_dist_sq_moving.launches == 0
    phase_evaluator(kernels, device)
    _elapsed(t_start, "evaluator")
    box_dwa_k9 = phase_box_dwa(kernels, device)
    _elapsed(t_start, "box_dwa")
    # every K10 launch since the fleet-solver phase: the card solves of the
    # fleet-solver, evaluator and BOX DWA phases
    solve_k10 = kernels.goal_nearest.launches
    form_errs = phase_tpu_forms_vs_plain(kernels, device)
    _elapsed(t_start, "tpu_forms_vs_plain")
    _zero_launches(kernels)
    form_launches = phase_ticks(kernels, device)
    _elapsed(t_start, "ticks")
    log(f"k-tick loop main-path launches (run_ticks_on_device calls only): "
        f"{form_launches}")
    assert all(form_launches.get(key) for key in ("K3", "K6", "K7", "K8"))
    phase_ticks_cpu(device)
    _elapsed(t_start, "ticks_cpu")
    phase_emergency(device)
    _elapsed(t_start, "emergency")
    _zero_launches(kernels)
    peer_launches, peer_wrapped = phase_peers(kernels, device)
    _elapsed(t_start, "peers")
    peer_ticks = phase_peer_ticks(kernels, device)
    _elapsed(t_start, "peer_ticks")
    counted = {k: c for k, c in kernels.launch_counts().items() if c}
    # the wrappers also ran the k-tick phase's eager reference loops, k per
    # call, and its capture, which launches nothing; its replays launch
    # without a wrapper (phase_peer_ticks counts them); K10 in every form
    per_form = (2 + TICKS_CALLS) * TICKS_K
    assert counted == {k: peer_wrapped.get(k, 0)
                       + per_form * (len(PEER_FORMS) if k == "K10" else k in peer_ticks)
                       for k in set(peer_wrapped) | set(peer_ticks)}, counted
    for key, n in peer_ticks.items():
        peer_launches[key] = peer_launches.get(key, 0) + n
    log(f"peer path main-path launches: {peer_launches} (wrapper calls, the eager "
        f"reference loops included: {counted})")
    assert all(peer_launches.get(key) for key in ("K1", "K3", "K7", "K8"))
    peer_errs = phase_peer_sweeps_vs_plain(kernels, device)
    _elapsed(t_start, "peer_sweeps_vs_plain")
    k3s_err, k9_err = phase_box_sweeps_vs_plain(kernels, device)
    _elapsed(t_start, "box_sweeps_vs_plain")
    phase_heading_flips(kernels, device)
    _elapsed(t_start, "heading_flips")
    _zero_launches(kernels)
    split_launches = phase_split_fleet(kernels, device)
    _elapsed(t_start, "split_fleet")
    box_launches = phase_box_fleet(kernels, device)
    _elapsed(t_start, "box_fleet")
    log(f"split and BOX fleet main-path launches: {split_launches}, {box_launches} "
        f"(wrapper calls, the comparisons and the wide split side run included: "
        f"{ {k: c for k, c in kernels.launch_counts().items() if c} })")
    assert split_launches["K3s"] and box_launches["K9"] and box_dwa_k9
    phase_controllers(device)
    _elapsed(t_start, "controllers")
    tick_p50 = phase_times(kernels, device, card)
    _elapsed(t_start, "times")
    static_times = phase_static_times(kernels, device, card)
    _elapsed(t_start, "static_times")
    k3_times = phase_fleet_times(kernels, device, card)
    _elapsed(t_start, "fleet_times")
    k5_times = phase_mapping_times(kernels, device, card)
    _elapsed(t_start, "mapping_times")
    phase_solver_times(kernels, device, card)
    _elapsed(t_start, "solver_times")
    form_times = phase_tpu_forms_times(kernels, device, card)
    _elapsed(t_start, "tpu_forms_times")
    phase_ticks_times(device, card)
    _elapsed(t_start, "ticks_times")
    phase_peer_sweep_times(kernels, device, card)
    _elapsed(t_start, "peer_sweep_times")
    phase_peer_times(device, card)
    _elapsed(t_start, "peer_times")
    k3s_times, k9_times = phase_split_box_times(kernels, device, card)
    _elapsed(t_start, "split_box_times")
    k10_err, k10_times = phase_goal(device, card)
    _elapsed(t_start, "goal")
    phase_replay_profile(device, card)
    _elapsed(t_start, "replay_profile")
    t_plan = time.perf_counter()
    phase_planners(device, card)
    _elapsed(t_start, "planners")
    phase_planning_card_vs_cpu(device, card)
    _elapsed(t_start, "planning_card_vs_cpu")
    phase_planning_replay(device, card)
    _elapsed(t_start, "planning_replay")
    phase_planning_fleet(device, card)
    _elapsed(t_start, "planning_fleet")
    log(f"planning phases: {time.perf_counter() - t_plan:.1f} s")
    _zero_launches(kernels)
    t_serve = time.perf_counter()
    serve_times, served = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        _tally(served, phase_serving_solver(kernels, device, tmp, serve_times))
        paths = export_fleet_artifacts(tmp, serve_times)
        _tally(served, phase_serving_fleet(kernels, device, paths, serve_times))
        _tally(served, phase_serving_resume(kernels, device, tmp, paths))
    log(f"serving path launches: served calls {served} (every wrapper launch, the "
        f"live comparisons included: { {k: c for k, c in kernels.launch_counts().items() if c} })")
    assert all(served.get(key) for key in ("K1", "K3", "K6", "K7", "K8")), served
    phase_serving_times(card, serve_times, tick_p50)
    _elapsed(t_start, "serving_times")
    log(f"serving phases: {time.perf_counter() - t_serve:.1f} s")
    _zero_launches(kernels)
    t_mesh = time.perf_counter()
    mesh = phase_mesh_fleet(kernels, device)
    _elapsed(t_start, "mesh_fleet")
    for key, n in phase_mesh_solver(kernels, device).items():
        mesh[key] = mesh.get(key, 0) + n
    _elapsed(t_start, "mesh_solver")
    mp_wall, mp_launches = phase_mesh_multiprocess(kernels, device)
    _elapsed(t_start, "mesh_multiprocess")
    runtime_launches, runtime_ms = phase_fleet_runtime(kernels, device)
    _elapsed(t_start, "fleet_runtime")
    for key, n in (*mp_launches.items(), *runtime_launches.items()):
        mesh[key] = mesh.get(key, 0) + n
    log(f"mesh path launches: {mesh} (the mesh calls and the workers' own; every "
        f"wrapper launch in this process, the one-device comparisons included: "
        f"{ {k: c for k, c in kernels.launch_counts().items() if c} })")
    assert all(mesh.get(key) for key in ("K1", "K2", "K3", "K4", "K6", "K7", "K8")), mesh
    phase_mesh_times(kernels, device, card, mp_wall, runtime_ms)
    _elapsed(t_start, "mesh_times")
    log(f"mesh phases: {time.perf_counter() - t_mesh:.1f} s")
    recorded = phase_recorded(kernels, device)
    _elapsed(t_start, "recorded")
    bench, bench_err = phase_benchmark(kernels, device, card)
    _elapsed(t_start, "benchmark")
    _zero_launches(kernels)
    tools = phase_benchmark_tools(kernels, device, card)
    _elapsed(t_start, "benchmark_tools")
    assert all(tools.get(key) for key in ("K1", "K3", "K3s", "K5")), tools
    _zero_launches(kernels)
    workflows = phase_examples(kernels, device, card)
    _elapsed(t_start, "examples")
    assert all(workflows.get(key) for key in ("K1", "K3", "K5")), workflows
    twins = phase_card_twins(kernels, card)
    _elapsed(t_start, "card_twins")
    assert "jax" not in sys.modules, "the port loaded jax"
    assert not any(m.split(".")[0] == "kompass_core_tpu" for m in sys.modules), (
        "the port loaded the JAX package")

    def row(name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by):
        # library_ms: no single PyTorch call computes any of these functions
        # (torch.cdist gives distances, not their squares, and the min over
        # the rows is a second call; nothing computes the line test)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [
        row("fused_min_dist_sq", KERNEL_SOURCE, KERNEL_REPLACES,
            slice_launches["K1"] + peer_launches["K1"] + split_launches["K1"] + served["K1"]
            + mesh["K1"] + recorded["K1"] + bench["K1"] + tools["K1"] + workflows["K1"]
            + twins.get("K1", 0),
            max(k1_err, peer_errs["K1"], bench_err), *static_times["K1"]),
        row("fused_min_dist_sq_expanded", KERNEL_SOURCE, EXPANDED_REPLACES,
            k2_launches + mesh["K2"] + twins.get("K2", 0), k2_err, *static_times["K2"]),
        row("fused_min_dist_sq_moving", KERNEL_SOURCE, MOVING_REPLACES,
            fleet_launches["K3"] + peer_launches["K3"] + box_launches["K3"] + served["K3"]
            + mesh["K3"] + tools["K3"] + workflows["K3"] + twins.get("K3", 0),
            max(k3_err, peer_errs["K3"]), *k3_times),
        row("min_dist_sq_moving", KERNEL_SOURCE, K3S_REPLACES,
            split_launches["K3s"] + tools["K3s"] + twins.get("K3s", 0),
            k3s_err, *k3s_times),
        row("min_dist_sq_expanded", KERNEL_SOURCE, SINGLE_REPLACES,
            k4_launches + mesh["K4"] + twins.get("K4", 0), k4_err, *static_times["K4"]),
        row("scan_to_grid_cells", MAP_SOURCE, MAP_REPLACES,
            k5_launches + recorded["K5"] + bench["K5"] + tools["K5"] + workflows["K5"]
            + twins.get("K5", 0),
            k5_err, *k5_times),
        row("fused_min_dist_sq_broadcast", KERNEL_SOURCE, BROADCAST_REPLACES,
            form_launches["K6"] + served["K6"] + mesh["K6"] + twins.get("K6", 0),
            max(form_errs["K6"], peer_errs["K6"]),
            *form_times["K6"]),
        row("fused_min_dist_sq_moving_expanded", KERNEL_SOURCE,
            MOVING_EXPANDED_REPLACES,
            form_launches["K7"] + peer_launches["K7"] + served["K7"] + mesh["K7"]
            + twins.get("K7", 0),
            max(form_errs["K7"], peer_errs["K7"]), *form_times["K7"]),
        row("fused_min_dist_sq_moving_broadcast", KERNEL_SOURCE,
            MOVING_BROADCAST_REPLACES,
            form_launches["K8"] + peer_launches["K8"] + served["K8"] + mesh["K8"]
            + twins.get("K8", 0),
            max(form_errs["K8"], peer_errs["K8"]), *form_times["K8"]),
        row("box_min_dist_sq", K9_SOURCE, K9_REPLACES,
            box_dwa_k9 + box_launches["K9"] + twins.get("K9", 0), k9_err, *k9_times),
        row("goal_nearest", K10_SOURCE, K10_REPLACES,
            solve_k10 + sum(d.get("K10", 0) for d in (
                slice_launches, fleet_launches, form_launches, peer_launches,
                split_launches, box_launches, served, mesh, recorded, bench, tools,
                workflows, twins)),
            k10_err, *k10_times),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
