"""The yardstick of the sweep kernels' roofline shares: each sweep's
operations and bytes as functions of the cell's shapes, and the card's
published peaks.

The counts are the function's, not an implementation's: per (rollout
point, obstacle or segment row) pair, the direct squared distance is 2
subtractions, 2 multiplications, 1 addition and 1 min (6 operations);
the oriented-box distance (K9) is 2 subtractions to the row, 4
multiplications and 2 additions to rotate it into the body frame, 2
subtractions of the half extents, 2 clamps at zero, 2 multiplications
and 1 addition for the squared norm and 1 min (16; the absolute values
and the negation are sign operations, not counted). A moving row's
position at each rollout step, o + v * t * dt, adds 2 multiplications and
2 additions per (moving row, step) per robot. Only the steps a robot's
adaptive horizon keeps (``active_points``) are counted. Every input byte
is read once and every output byte written once: the rollout points
(and, for the box, the heading's cos and sin), the rows (and the moving
rows' velocities), the per-robot scalars, and the [S, T] fields written.

The rows are the function's, from the configuration and the cell's
inputs, never an implementation's padded buckets: the scan's rays and
the tracked slots, the other robots' peer discs (ring points and
centre), and the path window's lookahead + 1 segment points.

Peaks: NVIDIA's published H100 SXM rates, 67e12 FP32 operations per
second outside the tensor cores and 3.35e12 bytes per second of HBM3.
"""

FP32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12

PAIR_OPS = {"direct": 6, "box": 16}
MOVING_ROW_STEP_OPS = 4
F32 = 4

# the program's sweep kernels (``csrc/*.cu``) by the name its trace gives
SWEEP_KERNELS = ("static_min_dist_kernel", "moving_min_dist_kernel",
                 "point_major_min_dist_kernel", "box_min_dist_kernel")


def is_sweep(kernel_name: str) -> bool:
    return any(k in kernel_name for k in SWEEP_KERNELS)


def sweep_work(kind, *, samples, steps, active_steps, robots, rows, seg_rows=0,
               moving_rows=0):
    """(operations, bytes) of one sweep over ``robots`` robots: ``kind``
    "direct" (obstacle and segment fields, K1 / K3) or "box" (K9);
    ``active_steps`` the sum of the robots' active steps, ``steps`` the
    rollout length T, ``rows`` the obstacle rows per robot, of which
    ``moving_rows`` move, ``seg_rows`` the segment rows (direct only)."""
    pairs = samples * active_steps * (rows + seg_rows)
    ops = PAIR_OPS[kind] * pairs + MOVING_ROW_STEP_OPS * active_steps * moving_rows
    field = samples * steps * F32
    if kind == "direct":
        inputs = 2 * field + 2 * F32 * (rows + seg_rows) + F32
        outputs = (2 if seg_rows else 1) * field
    else:
        inputs = 4 * field + 2 * F32 * rows + 2 * F32 + F32
        outputs = field
    if moving_rows:
        inputs += 2 * F32 * moving_rows + F32
    return ops, robots * (inputs + outputs)


def least_seconds(ops, nbytes):
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / FP32_PEAK, nbytes / HBM_BYTES_PER_S)


def tick_work(shape: dict, robot_ticks: int, active_steps: int):
    """[(operations, bytes)] per sweep kind of ``robot_ticks`` robot-ticks
    of a configuration's ``shape`` (``sweep_shape``) holding
    ``active_steps`` active steps in all."""
    common = dict(samples=shape["samples"], steps=shape["steps"],
                  active_steps=active_steps, robots=robot_ticks, rows=shape["rows"],
                  moving_rows=shape["moving_rows"])
    work = [sweep_work("direct", seg_rows=shape["seg_rows"], **common)]
    if shape["box"]:
        work.append(sweep_work("box", **common))
    return work


def sweep_shape(layout) -> dict:
    """The sweeps' sizes of a reference ``Layout``: samples, steps,
    obstacle rows (the rays, the tracked slots and the other robots' peer
    discs), of them the moving rows (tracked slots; peer discs with
    prediction), the segment rows, and whether the box field runs."""
    peers = layout.peers
    peer_rows = (layout.n - 1) * (peers["ring"] + 1) if peers else 0
    moving = layout.tracked + (peer_rows if peers and peers["predict"] else 0)
    return dict(samples=layout.S, steps=layout.T,
                rows=layout.rays + layout.tracked + peer_rows, moving_rows=moving,
                seg_rows=layout.lookahead + 1, box=layout.has_box)
