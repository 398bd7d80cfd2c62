"""The port's occupancy mapper against the JAX package's, on the CPU.

Both packages get the same seeded numpy inputs. The JAX side runs as its
users run it: jitted, with the candidate lookup as the whole-grid
one-hot dot (``KOMPASS_TPU_LOOKUP=full``, the CPU default) or as the
Pallas kernel K5 in interpret mode (``=pallas``). On CPU tensors the
port's per-cell pass is the plain version of its CUDA kernel.

Held exactly: nearest bins, cell distances, beam endpoint cells, the
per-cell candidates (endpoint cells, ranges and validity, bit for bit),
the occupancy grids, the probability grids and the warped grids (bit
for bit: the port reproduces XLA's reciprocal multiplies and FMAs, see
``kompass_core_tpu_torch/ops/mapping.py``), the pointcloud scans and
every layer of the two ``LocalMapper``s run in lockstep (the port's
mapper is given the port's own scan, pose and model objects, built from
the same values by ``to_port``).

The lockstep grids are 64 cells wide. XLA compiles the columns left over
by its 8-wide vector loop with other FMA choices, so on a 60-wide grid
the JAX warp's last 4 columns round the bilinear source coordinate
differently from its other columns (by one ulp, about 1e-6 in the
probability); the port rounds every column alike.
"""

import json
import math
import os
import jax
import numpy as np
import pytest
import torch

from kompass_core_tpu.datatypes import LaserScanData, PointCloudData
from kompass_core_tpu.datatypes.pose import PoseData
from kompass_core_tpu.datatypes.scan_model import ScanModelConfig
from kompass_core_tpu.mapping import LocalMapper as JaxLocalMapper
from kompass_core_tpu.mapping import MapConfig as JaxMapConfig
from kompass_core_tpu.ops import mapping as jm
from kompass_core_tpu_torch.mapping import OCCUPANCY_TYPE, LocalMapper, MapConfig
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops import mapping as pm

from test_torch_host_modules import to_port

RES = os.path.join(os.path.dirname(__file__), "resources", "reference")

SPECS = {
    "61x61/72": jm.MapperSpec(61, 61, 72, 0.1),
    "64x64/720": jm.MapperSpec(64, 64, 720, 0.05),
    # non-square, laser offset and rotated
    "40x56/300 offset": jm.MapperSpec(40, 56, 300, 0.07, 0.13, -0.21, 0.7),
}
FULL_SIZE = jm.MapperSpec(400, 400, 3600, 0.05)
# the reference benchmark's Bayesian mapper: p_prior, p_empty,
# p_occupied, range_sure, range_max, wall_size
BAYES = tuple(np.float32(v) for v in (0.6, 0.1, 0.9, 0.1, 20.0, 0.2))
CPU = torch.device("cpu")


def _ranges(spec, seed, robots=None):
    """Seeded ranges over the grid, with 0, NaN, +inf and negative
    (invalid) beams."""
    rng = np.random.default_rng(seed)
    B = spec.num_bins
    shape = (B,) if robots is None else (robots, B)
    r = rng.uniform(0.05, 0.6 * spec.grid_height * spec.resolution, shape)
    r = r.astype(np.float32)
    flat = r.reshape(-1, B)
    flat[:, rng.integers(0, B, B // 10)] = 0.0
    flat[:, 3], flat[:, 11], flat[:, -1] = np.nan, np.inf, -1.0
    return r


def _prev(spec, seed, robots=None):
    rng = np.random.default_rng(seed + 100)
    shape = (spec.grid_height, spec.grid_width)
    if robots is not None:
        shape = (robots,) + shape
    return rng.uniform(0.05, 0.95, shape).astype(np.float32)


def _port_cells(spec, ranges):
    """The port's geometry, beam tables and gathered candidates on CPU."""
    ps = pm.mapper_spec_from_jax(spec)
    geo = pm._geometry_for(ps, 0.0, CPU)
    tables, endpoint = pm._beam_side(ps, geo, torch.from_numpy(ranges)[None])
    return geo, tables, endpoint


# --- geometry and beam side ----------------------------------------------------


@pytest.mark.parametrize("name", [*SPECS, "400x400/3600"])
def test_geometry_matches_jax(name):
    """Nearest bin and cell distance per cell, computed once per spec."""
    spec = SPECS.get(name, FULL_SIZE)

    def jax_geometry():
        _, _, d, theta = jm._cell_geometry(spec)
        return jm._base_bin(spec, theta, 0.0), d * spec.resolution

    base, dist_m = jax.jit(jax_geometry)()
    geo = pm._geometry_for(pm.mapper_spec_from_jax(spec), 0.0, CPU)
    assert geo.base.dtype == torch.int32
    np.testing.assert_array_equal(geo.base.numpy(), np.asarray(base))
    np.testing.assert_array_equal(geo.dist_m.numpy(), np.asarray(dist_m))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", [*SPECS, "400x400/3600"])
def test_beam_endpoint_cells_match_jax(name, seed):
    spec = SPECS.get(name, FULL_SIZE)
    ranges = _ranges(spec, seed)
    clean, _ = jm._sanitize_beams(ranges)
    e_i, e_j = jax.jit(lambda r: jm._beam_endpoint_cells(spec, r, 0.0))(clean)
    ps = pm.mapper_spec_from_jax(spec)
    geo = pm._geometry_for(ps, 0.0, CPU)
    p_clean, _ = pm._sanitize_beams(torch.from_numpy(ranges))
    p_i, p_j = pm._beam_endpoint_cells(ps, geo, p_clean)
    np.testing.assert_array_equal(p_i.numpy(), np.asarray(e_i))
    np.testing.assert_array_equal(p_j.numpy(), np.asarray(e_j))


@pytest.mark.parametrize(
    "mode,name",
    [("full", n) for n in SPECS] + [("pallas", "64x64/720")],
)
def test_candidates_bit_equal_jax_lookup(monkeypatch, mode, name):
    """K5 parity: the port's gathered candidates (endpoint cells, ranges,
    validity) equal JAX ``_candidate_lookup``'s bit for bit, as the
    whole-grid one-hot dot and as the Pallas kernel in interpret mode
    (tile 16, win 128, as tests/test_mapping.py runs it)."""
    spec = SPECS[name]
    monkeypatch.setenv("KOMPASS_TPU_LOOKUP", mode)
    monkeypatch.setenv("KOMPASS_TPU_BAND_TILE", "16")
    monkeypatch.setenv("KOMPASS_TPU_BAND_WIN", "128")
    if mode == "pallas":
        assert jm._banded_plan(spec, 0.0, 16, 128) is not None
    for seed in (0, 1):
        ranges = _ranges(spec, seed)

        def lookup(r):
            clean, valid = jm._sanitize_beams(r)
            _, _, _, theta = jm._cell_geometry(spec)
            base = jm._base_bin(spec, theta, 0.0)
            return jm._candidate_lookup(spec, base, clean, 0.0, valid=valid)

        want = [np.asarray(a) for a in jax.jit(lookup)(ranges)]
        geo, tables, _ = _port_cells(spec, ranges)
        cand = kernels.scan_to_grid_candidates(geo.base, tables)[0]
        got = [cand[..., 0], cand[..., 1], cand[..., 2].view(torch.float32),
               cand[..., 3] != 0]
        for g, w, what in zip(got, want, ("e_i", "e_j", "range", "valid")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {seed}")


# --- the grids -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SPECS))
def test_scan_to_grid_matches_jax(name):
    spec = SPECS[name]
    ps = pm.mapper_spec_from_jax(spec)
    for seed in (0, 1, 2):
        ranges = _ranges(spec, seed)
        want = np.asarray(jm.get_scan_to_grid(spec)(ranges))
        got = pm.get_scan_to_grid(ps, CPU)(ranges)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert {-1, 0, 100} == set(np.unique(want))


@pytest.mark.parametrize("name", list(SPECS))
def test_scan_to_grid_bayesian_matches_jax(name):
    spec = SPECS[name]
    ps = pm.mapper_spec_from_jax(spec)
    for seed in (0, 1):
        ranges, prev = _ranges(spec, seed), _prev(spec, seed)
        occ, prob = jm.get_scan_to_grid_bayesian(spec)(ranges, prev, *BAYES)
        p_occ, p_prob = pm.get_scan_to_grid_bayesian(ps, CPU)(ranges, prev, *BAYES)
        np.testing.assert_array_equal(p_occ.numpy(), np.asarray(occ))
        np.testing.assert_array_equal(p_prob.numpy(), np.asarray(prob))


@pytest.mark.parametrize(
    "shift,yaw",
    [((0.0, 0.0), 0.0), ((0.5, 0.0), 0.0), ((0.13, -0.27), 0.11),
     ((-0.31, 0.2), -0.4), ((1.7, 2.9), 3.0)],
)
def test_warp_previous_grid_matches_jax(shift, yaw):
    for spec in (SPECS["61x61/72"], SPECS["40x56/300 offset"]):
        prev = _prev(spec, 3)
        args = (np.asarray(shift, np.float32), np.float32(yaw), np.float32(0.6))
        want = np.asarray(jm.get_warp_previous_grid(spec)(prev, *args))
        got = pm.get_warp_previous_grid(pm.mapper_spec_from_jax(spec), CPU)(prev, *args)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(SPECS))
def test_scan_to_grid_bayesian_warped_matches_jax(name):
    spec = SPECS[name]
    ranges, prev = _ranges(spec, 4), _prev(spec, 4)
    shift, yaw = np.array([0.21, -0.08], np.float32), np.float32(0.07)
    want = jm.get_scan_to_grid_bayesian_warped(spec)(ranges, prev, shift, yaw, *BAYES)
    got = pm.get_scan_to_grid_bayesian_warped(pm.mapper_spec_from_jax(spec), CPU)(
        ranges, prev, shift, yaw, *BAYES)
    for g, w, what in zip(got, want, ("occ", "prob", "warped")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)


def _cloud(seed, n=5000):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.2, 6.0, n)
    a = rng.uniform(-np.pi, np.pi, n)
    pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-1.5, 1.5, n)], 1)
    pts = pts.astype(np.float32)
    pts[:50] = 0.0  # origin points
    pts[50:60, :2] = 1e-4  # inside the origin filter
    pts[60:80, 2] = 9.0  # above any ceiling
    return pts


@pytest.mark.parametrize(
    "num_bins,range_max,min_z,max_z",
    [(72, 10.0, -1.0, 1.0), (360, 4.0, -0.2, 2.0), (360, 10.0, -1.0, -1.0),
     (3600, 10.0, -1.0, 1.0), (8, 10.0, -1.0, 0.5)],
)
def test_pointcloud_to_scan_matches_jax(num_bins, range_max, min_z, max_z):
    """Bin-min ranges equal, with origin points, z-filtered points and the
    negative-max_z sentinel (no upper filter)."""
    for seed in (0, 1):
        pts = _cloud(seed)
        args = tuple(np.float32(v) for v in (range_max, min_z, max_z))
        want = np.asarray(jm.get_pointcloud_to_scan(num_bins)(pts, *args))
        got = pm.get_pointcloud_to_scan(num_bins, CPU)(pts, *args)
        np.testing.assert_array_equal(got.numpy(), want)
    if max_z < 0:  # the sentinel keeps the 9 m points
        high = pts[60:80]
        ranges = pm.get_pointcloud_to_scan(num_bins, CPU)(high, *args).numpy()
        assert np.isfinite(ranges).all() and (ranges < range_max).any()


def test_pad_cloud_to_bucket_matches_jax():
    for n in (0, 1, 4096, 5000):
        pts = _cloud(0, max(n, 1))[:n]
        np.testing.assert_array_equal(pm.pad_cloud_to_bucket(pts),
                                      jm.pad_cloud_to_bucket(pts))


@pytest.mark.parametrize("bayesian", [False, True])
def test_fleet_mappers_match_per_robot_jax(bayesian):
    """Three robots through the port's fleet callables equal three
    one-robot JAX calls."""
    spec = SPECS["40x56/300 offset"]
    ps = pm.mapper_spec_from_jax(spec)
    ranges, prev = _ranges(spec, 5, robots=3), _prev(spec, 5, robots=3)
    before = kernels.scan_to_grid_cells.launches
    if bayesian:
        occ, prob = pm.get_scan_to_grid_bayesian_fleet(ps, CPU)(ranges, prev, *BAYES)
        assert prob.shape == (3, 40, 56)
    else:
        occ = pm.get_scan_to_grid_fleet(ps, CPU)(ranges)
    assert occ.shape == (3, 40, 56)
    assert kernels.scan_to_grid_cells.launches == before  # CPU: plain version
    for i in range(3):
        if bayesian:
            o, p = jm.get_scan_to_grid_bayesian(spec)(ranges[i], prev[i], *BAYES)
            np.testing.assert_array_equal(prob[i].numpy(), np.asarray(p))
        else:
            o = jm.get_scan_to_grid(spec)(ranges[i])
        np.testing.assert_array_equal(occ[i].numpy(), np.asarray(o))


def test_sqrt_helper_is_correctly_rounded():
    """The port's sqrt equals numpy's (IEEE) on every float32 integer below
    2^20; PyTorch's own CPU float32 sqrt does not on every host."""
    x = torch.arange(1 << 20, dtype=torch.float32)
    np.testing.assert_array_equal(kernels._sqrt(x).numpy(), np.sqrt(x.numpy()))


def test_mapper_spec_from_jax_carries_every_field():
    spec = SPECS["40x56/300 offset"]
    ps = pm.mapper_spec_from_jax(spec)
    assert ps == pm.MapperSpec(40, 56, 300, 0.07, 0.13, -0.21, 0.7)
    assert ps.start_cell == spec.start_cell
    assert ps.central_point == spec.central_point


def test_per_cell_pass_checks_its_inputs():
    spec = pm.mapper_spec_from_jax(SPECS["61x61/72"])
    geo, tables, endpoint = _port_cells(SPECS["61x61/72"], _ranges(SPECS["61x61/72"], 0))
    with pytest.raises(ValueError, match="prev and params"):
        kernels.scan_to_grid_cells(geo.base, geo.dist_m, tables, endpoint,
                                   spec.start_cell, prev=torch.zeros(1, 61, 61))
    with pytest.raises(TypeError, match="int32"):
        kernels.scan_to_grid_cells(geo.base.long(), geo.dist_m, tables, endpoint,
                                   spec.start_cell)
    with pytest.raises(ValueError, match="endpoint"):
        kernels.scan_to_grid_cells(geo.base, geo.dist_m, tables, endpoint[:, 1:],
                                   spec.start_cell)


# --- LocalMapper in lockstep ---------------------------------------------------


def _room_scan(pose, n=180, seed=0):
    """A scan of a 5 x 4 m room with a pillar, from ``pose``, with a few
    NaN dropouts and no-echo beams."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    yaw = pose.get_yaw()
    th = angles + yaw
    dx, dy = np.cos(th), np.sin(th)
    best = np.full(n, np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for wall, axis in ((2.5, 0), (-2.5, 0), (2.0, 1), (-2.0, 1)):
            d = dx if axis == 0 else dy
            p = pose.x if axis == 0 else pose.y
            t = (wall - p) / d
            best = np.where((t > 0) & (t < best), t, best)
    ox, oy = 1.0 - pose.x, 0.7 - pose.y
    b = dx * ox + dy * oy
    disc = b * b - (ox * ox + oy * oy - 0.3**2)
    t = b - np.sqrt(np.maximum(disc, 0.0))
    best = np.where((disc >= 0) & (t > 0) & (t < best), t, best)
    best[rng.integers(0, n, 4)] = np.nan
    best[rng.integers(0, n, 3)] = np.inf
    return LaserScanData(ranges=best, angles=angles)


def _room_cloud(pose, seed=0):
    scan = _room_scan(pose, n=720, seed=seed)
    ok = np.isfinite(scan.ranges)
    r, a = scan.ranges[ok], scan.angles[ok]
    z = np.random.default_rng(seed).uniform(-0.5, 2.5, r.size)
    pts = np.stack([r * np.cos(a), r * np.sin(a), z], 1).astype(np.float32)
    return PointCloudData(points=np.concatenate([pts, np.zeros((7, 3), np.float32)]))


def _poses(n):
    poses = []
    for k in range(n):
        p = PoseData()
        p.set_position(x=-0.4 + 0.15 * k, y=0.1 * np.sin(k), z=0.0)
        p.set_yaw(0.2 * k - 0.3)
        poses.append(p)
    return poses


def _assert_same_layers(jax_mapper, port, what):
    np.testing.assert_array_equal(port.occupancy, jax_mapper.occupancy,
                                  err_msg=f"{what}: occupancy")
    np.testing.assert_array_equal(port.probabilistic_occupancy,
                                  jax_mapper.probabilistic_occupancy,
                                  err_msg=f"{what}: probabilistic occupancy")
    if jax_mapper.config.baysian_update:
        np.testing.assert_array_equal(port._prev_prob.numpy(),
                                      np.asarray(jax_mapper._prev_prob),
                                      err_msg=f"{what}: probability grid")
        np.testing.assert_array_equal(
            port.previous_grid_prob_transformed,
            jax_mapper.previous_grid_prob_transformed,
            err_msg=f"{what}: warped grid")


def _mapper_pair(bayesian, scan_model=None, laser_pose=None, **config):
    config = dict(dict(width=6.4, height=5.0, resolution=0.1), **config)
    scan_model = scan_model or ScanModelConfig(
        p_prior=0.6, p_occupied=0.9, range_sure=0.1, range_max=20.0,
        wall_size=0.2, angle_step=2 * np.pi / 360, max_height=2.0,
        min_height=-0.2)
    jax_mapper = JaxLocalMapper(JaxMapConfig(baysian_update=bayesian, **config),
                                scan_model, laser_pose)
    port = LocalMapper(MapConfig(baysian_update=bayesian, **config),
                       *to_port((scan_model, laser_pose)), device="cpu")
    return jax_mapper, port


@pytest.mark.parametrize("sensor", ["laserscan", "pointcloud"])
@pytest.mark.parametrize("bayesian", [False, True])
def test_local_mapper_lockstep(bayesian, sensor):
    laser = PoseData()
    laser.set_position(x=0.12, y=-0.05, z=0.0)
    laser.set_yaw(0.3)
    jax_mapper, port = _mapper_pair(bayesian, laser_pose=laser)
    for k, pose in enumerate(_poses(4)):
        scan = _room_scan(pose, seed=k) if sensor == "laserscan" else _room_cloud(pose, k)
        jax_mapper.update_from_scan(pose, scan)
        port.update_from_scan(*to_port((pose, scan)))
        _assert_same_layers(jax_mapper, port, f"update {k}")
    assert port._spec == pm.mapper_spec_from_jax(jax_mapper._spec)
    assert (port.occupancy == OCCUPANCY_TYPE.OCCUPIED.value).sum() > 10
    assert (port.occupancy == OCCUPANCY_TYPE.EMPTY.value).sum() > 100
    if bayesian:
        warped = port.get_previous_grid_in_current_pose(np.array([0.2, 0.1]), 0.15)
        want = jax_mapper.get_previous_grid_in_current_pose(np.array([0.2, 0.1]), 0.15)
        np.testing.assert_array_equal(warped, want)


def test_local_mapper_sensor_switch_mid_run():
    jax_mapper, port = _mapper_pair(True)
    poses = _poses(5)
    for k, (pose, kind) in enumerate(zip(poses, "llcll")):
        scan = _room_scan(pose, seed=k) if kind == "l" else _room_cloud(pose, k)
        jax_mapper.update_from_scan(pose, scan)
        port.update_from_scan(*to_port((pose, scan)))
        _assert_same_layers(jax_mapper, port, f"update {k} ({kind})")
        assert port._spec.num_bins == jax_mapper._spec.num_bins


def test_local_mapper_continues_a_jax_mappers_state():
    """A port mapper handed a JAX mapper's mid-run state (probability
    grid, pose, spec) continues exactly as the JAX mapper does."""
    jax_mapper, port = _mapper_pair(True)
    poses = _poses(5)
    for k in range(2):
        jax_mapper.update_from_scan(poses[k], _room_scan(poses[k], seed=k))
    port._spec = pm.mapper_spec_from_jax(jax_mapper._spec)
    port._prev_prob = torch.from_numpy(np.array(jax_mapper._prev_prob))
    port._pose_robot_in_world = to_port(jax_mapper._pose_robot_in_world)
    port.processed = jax_mapper.processed
    for k in range(2, 5):
        scan = _room_scan(poses[k], seed=k)
        jax_mapper.update_from_scan(poses[k], scan)
        port.update_from_scan(*to_port((poses[k], scan)))
        _assert_same_layers(jax_mapper, port, f"update {k}")


@pytest.fixture
def recorded_scan() -> LaserScanData:
    with open(os.path.join(RES, "mapping", "laserscan_data.json")) as f:
        d = json.load(f)
    return LaserScanData(
        angle_min=d["angle_min"], angle_max=d["angle_max"],
        angle_increment=d["angle_increment"], range_min=d["range_min"],
        range_max=d["range_max"], ranges=np.asarray(d["ranges"], np.float64),
    )


@pytest.mark.parametrize("bayesian", [False, True])
def test_recorded_laserscan_fixture(recorded_scan, bayesian):
    """The recorded 360-ray scan with tests/test_reference_fixtures.py's
    configuration, twice from two poses."""
    jax_mapper, port = _mapper_pair(
        bayesian, ScanModelConfig(angle_step=recorded_scan.angle_increment),
        width=10.0, height=10.0, resolution=0.05)
    second = PoseData()
    second.set_position(x=0.3, y=-0.1, z=0.0)
    second.set_yaw(0.1)
    for pose in (PoseData(), second):
        jax_mapper.update_from_scan(pose, recorded_scan)
        port.update_from_scan(*to_port((pose, recorded_scan)))
        _assert_same_layers(jax_mapper, port, "recorded scan")
    assert (port.occupancy == 100).sum() > 50 and (port.occupancy == 0).sum() > 2000


def test_recorded_livox_pointcloud_fixture():
    with open(os.path.join(RES, "mapping", "livox_pointcloud_sample_1.json")) as f:
        d = json.load(f)
    fields = {fl["name"]: fl for fl in d["fields"]}
    cloud = PointCloudData.from_bytes(
        bytes(d["data"]), point_step=d["point_step"],
        x_offset=fields["x"]["offset"], y_offset=fields["y"]["offset"],
        z_offset=fields["z"]["offset"], dtype_code=fields["x"]["datatype"],
        row_step=d["row_step"], height=d["height"],
    )
    jax_mapper, port = _mapper_pair(
        False, ScanModelConfig(angle_step=np.deg2rad(1.0), max_height=2.0,
                               min_height=-0.2),
        width=10.0, height=10.0, resolution=0.1)
    jax_mapper.update_from_scan(PoseData(), cloud)
    port.update_from_scan(*to_port((PoseData(), cloud)))
    _assert_same_layers(jax_mapper, port, "livox cloud")
    assert (port.occupancy == 100).sum() > 0 and (port.occupancy == 0).sum() > 0


# --- the line test without divisions ---------------------------------------------


def test_quotient_bound_decides_as_the_division():
    """RN(n / d) <= h exactly when n <= F, for n at F and a few ulps on
    either side and for random n, over h and d with few and with many
    mantissa bits; no midpoint m * d is ever a float."""
    g = torch.Generator().manual_seed(0)
    n_pairs = 200_000
    mant = torch.randint(1, 1 << 24, (n_pairs,), generator=g).float()
    few = torch.randint(1, 1 << 6, (n_pairs,), generator=g).float()
    exps = torch.randint(-20, 12, (2, n_pairs), generator=g).float()
    h = torch.cat([mant, few]) * 2.0 ** torch.cat([exps[0], exps[1]])
    d = torch.cat([few, mant]) * 2.0 ** torch.cat([exps[1], exps[0]])
    bound = kernels._quotient_bound(h, d)
    inf = torch.full_like(h, math.inf)
    a = (h.double() + torch.nextafter(h, inf).double()) * 0.5 * d.double()
    assert not bool((a.float().double() == a).any())
    for steps in range(-3, 4):
        n = bound
        for _ in range(abs(steps)):
            n = torch.nextafter(n, inf if steps > 0 else -inf)
        assert torch.equal(n / d <= h, n <= bound), steps
    n = (torch.rand(h.shape, generator=g) * 4 - 2) * h * d
    assert torch.equal(n / d <= h, n <= bound)


def test_line_test_bounds_decide_as_the_divisions_on_every_cell():
    """Every cell of a 49 x 49 window against the line to every endpoint
    offset in [-20, 20]^2: the bounds give each of the three decisions
    of the JAX package's divided test (t >= -0.5, t <= L, perp <=
    halfwidth), endpoint cells (t = L) and cells on the diamond's edges
    among them (both as bit-for-bit grids in the tests above)."""
    v = torch.arange(-20, 21, dtype=torch.float32)
    vx, vy = (t.reshape(-1, 1) for t in torch.meshgrid(v, v, indexing="ij"))
    c = torch.arange(-24, 25, dtype=torch.float32)
    di, dj = (t.reshape(1, -1) for t in torch.meshgrid(c, c, indexing="ij"))
    L = kernels._sqrt(kernels._fma(vx, vx, vy * vy))
    L_safe = torch.clamp(L, min=1e-6)
    t = (di * vx + dj * vy) / L_safe
    perp = torch.abs(di * vy - dj * vx) / L_safe
    halfwidth = (torch.abs(vx) + torch.abs(vy)) / (2.0 * L_safe) + 1e-4
    t_lo, t_hi, p_hi = kernels.line_test_bounds(vx, vy).unbind(-1)
    n_t = di * vx + dj * vy
    n_p = torch.abs(di * vy - dj * vx)
    assert torch.equal(t >= -0.5, n_t >= t_lo)
    assert torch.equal((t <= L) & (L > 0), n_t <= t_hi)
    assert torch.equal(perp <= halfwidth, n_p <= p_hi)
    assert int((t == L).sum()) > 100
    # cells on a diamond's edge sit 1e-4 inside the halfwidth
    assert int((torch.abs(perp - halfwidth) <= 1.5e-4).sum()) > 100
