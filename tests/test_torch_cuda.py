"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device (the
decision is taken inside the test, never at import). Run on a GPU host
with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from kompass_core_tpu_torch.ops import kernels, solver
from kompass_core_tpu_torch.parallel import DeviceFleet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(seed, S, T, O, G, device):
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * 10).to(device)

    return u(S, T), u(S, T), u(O, 2), u(G), u(G)


@pytest.mark.parametrize(
    "S,T,O,G,active",
    [(2025, 30, 512, 384, 30), (2025, 30, 512, 384, 17), (37, 7, 700, 333, 5),
     (1, 2, 1, 1, 2), (300, 30, 4096, 64, 30), (1000, 40, 1, 1024, 40),
     (2025, 30, 1, 3, 30)],
)
def test_kernel_bit_identical_to_plain(cuda, S, T, O, G, active):
    args = _case(S * 7 + O, S, T, O, G, cuda)
    ap = torch.tensor(active, dtype=torch.int32, device=cuda)
    before = kernels.fused_min_dist_sq.launches
    got = kernels.fused_min_dist_sq(*args, ap)
    want = kernels.fused_min_dist_sq_reference(*args, ap)
    torch.cuda.synchronize()
    assert kernels.fused_min_dist_sq.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool(torch.isinf(g[:, active:]).all())


def test_kernel_reads_active_points_on_the_device(cuda):
    """Changing the device scalar between launches changes the mask, with
    no host value involved."""
    args = _case(3, 64, 10, 256, 128, cuda)
    ap = torch.tensor(10, dtype=torch.int32, device=cuda)
    full, _ = kernels.fused_min_dist_sq(*args, ap)
    ap.fill_(4)
    cut, _ = kernels.fused_min_dist_sq(*args, ap)
    assert bool(torch.isfinite(full).all())
    assert torch.equal(cut[:, :4], full[:, :4])
    assert bool(torch.isinf(cut[:, 4:]).all())


def test_wrapper_raises_on_mixed_devices(cuda):
    px, py, obs, sx, sy = _case(4, 8, 4, 16, 8, cuda)
    ap = torch.tensor(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)


def test_packed_solve_on_card_matches_cpu(cuda):
    spec = solver.SolverSpec(
        is_omni=False, n_vx=45, n_vy=1, n_omega=45, max_points=30,
        num_ctrl_points=6, scan_size=512, seg_size=384,
    )
    from kompass_core_tpu_torch.ops.window import sample_velocity_window

    rng = np.random.default_rng(0)
    limits = np.array([1.2, 1.5, 2.5, 0.0, 0.0, 0.0, 1.5, 3.0, 3.0])
    window = sample_velocity_window((0.6, 0.0, 0.1), limits, 0.1, 45, 1, 45, False)
    obs = np.full((512, 2), 1e8, np.float32)
    ang = rng.uniform(-np.pi, np.pi, 400)
    r = rng.uniform(0.4, 6.0, 400)
    obs[:400] = np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
    s = np.linspace(0.0, 3.8, 381).astype(np.float32)
    seg = [np.full(384, 1e8, np.float32) for _ in range(2)]
    arc = np.zeros(384, np.float32)
    seg[0][:381], seg[1][:381], arc[:381] = s, 0.2 * np.sin(s), s
    params = np.array([0.1, 0.25, 0.07, 3, 3, 1, 0, 0, 1.5, 0, 3, 10 / 3], np.float32)
    buf = np.zeros(solver.packed_input_size(spec), np.float32)
    solver.pack_solver_input(spec, buf, params, (0.0, 0.0, 0.1), window, obs, 400,
                             seg[0], seg[1], arc, 381, 3.8, 3.8, 30)
    before = kernels.fused_min_dist_sq.launches
    out = solver.make_packed_dwa_solver(spec, cuda)(buf).cpu().numpy()
    assert kernels.fused_min_dist_sq.launches == before + 1
    ref = solver.make_packed_dwa_solver(spec, "cpu")(buf.copy()).numpy()
    assert out[0] == ref[0] and out[3] == ref[3]  # found, num_admissible
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-4)
    np.testing.assert_allclose(out[4:], ref[4:], rtol=1e-5, atol=1e-5)


def _moving_case(seed, B, S, T, O, G, device):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, span=10.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * span).to(device)

    return (u(B, S, T), u(B, S, T), u(B, O, 2), u(B, O, 2, span=1.5),
            (0.05 + torch.rand(B, generator=g) * 0.1).to(device), u(B, G), u(B, G))


@pytest.mark.parametrize(
    "B,S,T,O,G,active",
    [(1, 2025, 30, 512, 384, 30), (1, 2025, 30, 512, 384, 11),
     (3, 37, 7, 700, 333, 5), (8, 2025, 30, 768, 384, 30)],
)
def test_moving_kernel_bit_identical_to_plain(cuda, B, S, T, O, G, active):
    px, py, obs, vel, dt, sx, sy = _moving_case(S + O + B, B, S, T, O, G, cuda)
    vel[:, -5:] = 0.0
    obs[:, -5:] = 1e8  # pad rows
    ap = torch.full((B,), active, dtype=torch.int32, device=cuda)
    before = kernels.fused_min_dist_sq_moving.launches
    got = kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)
    want = kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap, vel, dt)
    torch.cuda.synchronize()
    assert kernels.fused_min_dist_sq_moving.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool(torch.isinf(g[..., active:]).all())


def test_moving_kernel_at_zero_velocity_equals_the_static_kernel(cuda):
    px, py, obs, vel, dt, sx, sy = _moving_case(5, 4, 300, 30, 512, 384, cuda)
    ap = torch.tensor([30, 17, 2, 30], dtype=torch.int32, device=cuda)
    moving = kernels.fused_min_dist_sq_moving(
        px, py, obs, torch.zeros_like(vel), dt, sx, sy, ap
    )
    static = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
    for m, st in zip(moving, static):
        assert torch.equal(m, st)


@pytest.mark.parametrize(
    "B,S,T,O,G",
    [(2, 1025, 30, 1100, 333),  # S past one block of samples, two row tiles
     (3, 1023, 1, 768, 384),    # T = 1
     (1, 2025, 30, 1024, 1025)],
)
def test_moving_kernel_ragged_shapes(cuda, B, S, T, O, G):
    px, py, obs, vel, dt, sx, sy = _moving_case(S + O + G, B, S, T, O, G, cuda)
    ap = torch.full((B,), T, dtype=torch.int32, device=cuda)
    got = kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)
    want = kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap, vel, dt)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and bool(torch.isfinite(g).all())


def test_moving_kernel_keeps_nan_and_inf(cuda):
    """NaN and +-inf in points, obstacle rows, velocities and segment
    rows: robot 0 has all of them, robot 1 none (the fminf path), robot 2
    a NaN obstacle row only and robot 3 a NaN point only."""
    px, py, obs, vel, dt, sx, sy = _moving_case(9, 4, 300, 30, 1100, 384, cuda)
    nan, inf = float("nan"), float("inf")
    px[0, 3, 4], py[0, 7, 0], px[0, 11, 29] = nan, inf, -inf
    obs[0, 5, 0], obs[0, 9, 1], obs[0, 1050] = nan, inf, -inf
    vel[0, 17, 1] = inf  # inf * tau at t = 0 is NaN
    sx[0, 2], sy[0, 4] = nan, -inf
    obs[2, 600, 1] = nan
    py[3, 100, 12] = nan
    ap = torch.tensor([30, 30, 17, 30], dtype=torch.int32, device=cuda)
    got = kernels.fused_min_dist_sq_moving(px, py, obs, vel, dt, sx, sy, ap)
    want = kernels.fused_min_dist_sq_reference(px, py, obs, sx, sy, ap, vel, dt)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert bool(got[0][0].isnan().any()) and not bool(got[0][1].isnan().any())
    assert bool(got[0][2, :, :17].isnan().all()) and bool(got[0][3, 100, 12].isnan())


@pytest.mark.parametrize("B,S,O", [(1, 2025, 512), (8, 2025, 768)])
def test_moving_kernel_at_zero_velocity_equals_k1_at_path_shapes(cuda, B, S, O):
    px, py, obs, vel, dt, sx, sy = _moving_case(B + S, B, S, 30, O, 384, cuda)
    ap = torch.randint(2, 31, (B,), dtype=torch.int32).to(cuda)
    moving = kernels.fused_min_dist_sq_moving(
        px, py, obs, torch.zeros_like(vel), dt, sx, sy, ap)
    static = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
    for m, st in zip(moving, static):
        assert torch.equal(m, st)


def test_batched_static_kernel_equals_per_robot_launches(cuda):
    px, py, obs, _, _, sx, sy = _moving_case(6, 5, 2025, 30, 768, 384, cuda)
    ap = torch.tensor([30, 17, 2, 30, 9], dtype=torch.int32, device=cuda)
    batch = kernels.fused_min_dist_sq(px, py, obs, sx, sy, ap)
    for b in range(5):
        one = kernels.fused_min_dist_sq(px[b], py[b], obs[b], sx[b], sy[b], ap[b])
        for g, w in zip(batch, one):
            assert torch.equal(g[b], w)


def test_fleet_tick_on_card_matches_cpu(cuda):
    """Four diff-drive robots with tracked movers: the same fleet tick on
    the card and on the CPU gives the same found, num_admissible and
    command, and the cost within rel 1e-4; one moving-sweep launch."""
    from kompass_core_tpu_torch.control import DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )

    robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.2, 0.4])) for _ in range(4)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0, max_decel=6.0),
    )
    config = DWAConfig(max_linear_samples=12, max_angular_samples=12,
                       prediction_horizon=20, control_horizon=2)
    fleets = [DeviceFleet(robots, limits, config, 128, path_capacity=1024,
                          max_segments=16, tracked_obstacles=2, device=d)
              for d in (cuda, "cpu")]
    rng = np.random.default_rng(0)
    states = np.zeros((4, 4), np.float32)
    states[:, 0] = 0.0137
    states[:, 1] = 2.0 * np.arange(4)
    vels = np.tile(np.float32([0.4, 0.0, 0.1]), (4, 1))
    ranges = rng.uniform(0.8, 10.0, (4, 128)).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, 128, endpoint=False)
    tracked = np.full((4, 2, 4), np.nan, np.float32)
    tracked[:, 0] = (2.0, 1.0, 0.0, -0.6)
    tracked[:, 0, 1] += states[:, 1]
    for f in fleets:
        f.set_paths([np.array([[0.0, 2.0 * i], [6.0, 2.0 * i]]) for i in range(4)])
    before = kernels.fused_min_dist_sq_moving.launches
    gpu, cpu = (f.tick(states, vels, ranges, angles, tracked=tracked) for f in fleets)
    assert kernels.fused_min_dist_sq_moving.launches == before + 1
    for key in ("found", "reached", "num_admissible", "active_points", "vx",
                "vy", "omega"):
        np.testing.assert_array_equal(gpu[key], cpu[key], err_msg=key)
    np.testing.assert_allclose(gpu["cost"], cpu["cost"], rtol=1e-4)


# --- the mapper's per-cell kernel (K5) ------------------------------------------


def _mapper_inputs(spec, ranges, device, seed=0):
    from kompass_core_tpu_torch.ops import mapping

    geo = mapping._geometry_for(spec, 0.0, device)
    tables, endpoint = mapping._beam_side(spec, geo, ranges.to(device))
    rng = np.random.default_rng(seed)
    prev = torch.from_numpy(rng.uniform(0.05, 0.95, (ranges.shape[0],
                                                     spec.grid_height,
                                                     spec.grid_width))
                            .astype(np.float32)).to(device)
    params = mapping._params(device, 0.6, 0.1, 0.9, 0.1, 20.0, 0.2)
    return geo, tables, endpoint, prev, params


def _scan(spec, robots, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.05, 0.6 * spec.grid_height * spec.resolution,
                    (robots, spec.num_bins)).astype(np.float32)
    r[:, ::37] = 0.0
    r[:, 5], r[:, 9] = np.nan, np.inf
    return torch.from_numpy(r)


@pytest.mark.parametrize(
    "shape,robots",
    [((400, 400, 3600, 0.05, 0.0, 0.0, 0.0), 1),
     ((333, 517, 1000, 0.05, 0.13, -0.21, 0.4), 1),
     ((200, 200, 720, 0.05, 0.0, 0.0, 0.0), 8)],
)
@pytest.mark.parametrize("bayesian", [False, True])
def test_scan_to_grid_kernel_bit_identical_to_plain(cuda, shape, robots, bayesian):
    from kompass_core_tpu_torch.ops.mapping import MapperSpec

    spec = MapperSpec(*shape)
    geo, tables, endpoint, prev, params = _mapper_inputs(
        spec, _scan(spec, robots, 1), cuda)
    extra = (prev, params) if bayesian else ()
    before = kernels.scan_to_grid_cells.launches
    got = kernels.scan_to_grid_cells(geo.base, geo.dist_m, tables, endpoint,
                                     spec.start_cell, *extra)
    want = kernels.scan_to_grid_cells_reference(geo.base, geo.dist_m, tables,
                                                endpoint, spec.start_cell, *extra)
    torch.cuda.synchronize()
    assert kernels.scan_to_grid_cells.launches == before + 1
    for g, w in zip(got if bayesian else (got,), want if bayesian else (want,)):
        assert torch.equal(g, w)
    if robots > 1:  # a batch equals one-robot launches
        for b in range(robots):
            one = kernels.scan_to_grid_cells(
                geo.base, geo.dist_m, tables[b:b + 1].contiguous(),
                endpoint[b:b + 1].contiguous(), spec.start_cell,
                *((prev[b:b + 1].contiguous(), params) if bayesian else ()))
            for g, w in zip(got if bayesian else (got,),
                            one if bayesian else (one,)):
                assert torch.equal(g[b], w[0])


@pytest.mark.parametrize("shape", [(61, 61, 72, 0.1), (120, 90, 360, 0.05, 0.1, -0.2, 0.3)])
def test_scan_to_grid_kernel_on_line_test_boundaries(cuda, shape):
    """Every beam ends on a cell that reads it, which lies on the t = L
    bound: kernel == plain, plain and Bayesian."""
    from chip_smoke import boundary_tables
    from kompass_core_tpu_torch.ops.mapping import MapperSpec

    spec = MapperSpec(*shape)
    geo, _, endpoint, prev, params = _mapper_inputs(spec, _scan(spec, 1, 2), cuda)
    tables = boundary_tables(spec, geo).to(cuda)
    for extra in ((), (prev, params)):
        want = kernels.scan_to_grid_cells_reference(geo.base, geo.dist_m, tables,
                                                    endpoint, spec.start_cell, *extra)
        got = kernels.scan_to_grid_cells(geo.base, geo.dist_m, tables, endpoint,
                                         spec.start_cell, *extra)
        for g, w in zip(got if extra else (got,), want if extra else (want,)):
            assert torch.equal(g, w)
        occ = want[0] if extra else want
        assert int((occ == 0).sum()) > 0


@pytest.mark.parametrize("clip_range", [False, True])
def test_scan_to_grid_beam_pass_equals_line_test_bounds(cuda, clip_range):
    """K5's first launch writes each beam's line_test_bounds bit for bit:
    for the beam side's tables (zero-length lines included), and for
    endpoints anywhere in the 15-bit clip range."""
    from kompass_core_tpu_torch.ops.mapping import MapperSpec

    spec = MapperSpec(120, 90, 360, 0.05, 0.1, -0.2, 0.3)
    geo, tables, endpoint, _, _ = _mapper_inputs(spec, _scan(spec, 3, 4), cuda)
    if clip_range:
        g = torch.Generator().manual_seed(5)
        tables[..., :2] = torch.randint(-2**15, 2**15, tables[..., :2].shape,
                                        generator=g, dtype=torch.int32).to(cuda)
    si, sj = spec.start_cell
    _, _, got = kernels._scan_to_grid_cells_cuda(geo.base, geo.dist_m, tables,
                                                 endpoint, spec.start_cell, None, None)
    want = kernels.line_test_bounds((tables[..., 0] - si).float(),
                                    (tables[..., 1] - sj).float())
    assert torch.equal(got[..., :3], want.view(torch.int32))
    assert not bool(got[..., 3].any())


def test_local_mapper_bayesian_update_on_card_matches_cpu(cuda):
    """One Bayesian LocalMapper update at the full 400 x 400 / 3600 size on
    the card equals the same update on the CPU, with one K5 launch."""
    from kompass_core_tpu_torch.datatypes import LaserScanData, PoseData, ScanModelConfig
    from kompass_core_tpu_torch.mapping import LocalMapper, MapConfig

    config = MapConfig(width=20.0, height=20.0, resolution=0.05, baysian_update=True)
    model = ScanModelConfig(p_prior=0.6, p_occupied=0.9, range_sure=0.1,
                            range_max=20.0, wall_size=0.2)
    mappers = [LocalMapper(config, model, device=d) for d in (cuda, "cpu")]
    angles = np.linspace(-np.pi, np.pi, 3600, endpoint=False)
    rng = np.random.default_rng(0)
    pose = PoseData()
    for k in range(2):
        scan = LaserScanData(ranges=rng.uniform(0.5, 9.5, 3600), angles=angles)
        pose.set_position(x=0.1 * k, y=0.05 * k, z=0.0)
        pose.set_yaw(0.05 * k)
        before = kernels.scan_to_grid_cells.launches
        for m in mappers:
            m.update_from_scan(pose, scan)
        assert kernels.scan_to_grid_cells.launches == before + 1
        gpu, cpu = mappers
        np.testing.assert_array_equal(gpu.occupancy, cpu.occupancy)
        np.testing.assert_array_equal(gpu.probabilistic_occupancy,
                                      cpu.probabilistic_occupancy)
        assert torch.equal(gpu._prev_prob.cpu(), cpu._prev_prob)
        np.testing.assert_array_equal(gpu.previous_grid_prob_transformed,
                                      cpu.previous_grid_prob_transformed)


# --- the expanded sweeps (K2, K4) and the fleet solver's backends ---------------


@pytest.mark.parametrize(
    "B,S,T,O,G,active",
    [(0, 2025, 30, 512, 384, 30), (0, 2025, 30, 512, 384, 17),
     (0, 37, 7, 700, 333, 5), (0, 1, 2, 1, 1, 2), (8, 2025, 30, 512, 384, 30),
     (0, 1000, 40, 1, 1024, 40), (0, 2025, 30, 1, 3, 17)],
)
def test_expanded_kernels_bit_identical_to_plain(cuda, B, S, T, O, G, active):
    """K2 (both sweeps) and K4 (one sweep, over the obstacle rows and
    over the segment rows) equal their plain versions, pad rows and
    ragged tiles included; K4's fields are K2's."""
    px, py, obs, _, _, sx, sy = _moving_case(S + O + B + 1, max(B, 1), S, T, O,
                                             G, cuda)
    obs[:, -3:] = 1e8
    if B == 0:
        px, py, obs, sx, sy = px[0], py[0], obs[0], sx[0], sy[0]
        ap = torch.tensor(active, dtype=torch.int32, device=cuda)
    else:
        ap = torch.full((B,), active, dtype=torch.int32, device=cuda)
    seg = torch.stack([sx, sy], dim=-1).contiguous()
    before = (kernels.fused_min_dist_sq_expanded.launches,
              kernels.min_dist_sq_expanded.launches)
    k2 = kernels.fused_min_dist_sq_expanded(px, py, obs, sx, sy, ap)
    k4 = (kernels.min_dist_sq_expanded(px, py, obs, ap),
          kernels.min_dist_sq_expanded(px, py, seg, ap))
    want = kernels.fused_min_dist_sq_expanded_reference(px, py, obs, sx, sy, ap)
    want4 = kernels.min_dist_sq_expanded_reference(px, py, obs, ap)
    torch.cuda.synchronize()
    assert (kernels.fused_min_dist_sq_expanded.launches,
            kernels.min_dist_sq_expanded.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(k4[0], want4)
    for g, w, single in zip(k2, want, k4):
        assert torch.equal(g, w) and torch.equal(g, single)
        assert bool(torch.isinf(g[..., active:]).all())
        assert bool((g[..., :active] >= 0).all())


@pytest.mark.parametrize("backend,kernel,per_call", [
    ("xla", "fused_min_dist_sq", 1), ("pallas", "fused_min_dist_sq_expanded", 1),
    ("pallas_v1", "min_dist_sq_expanded", 2)])
def test_fleet_solver_on_card_matches_cpu(cuda, backend, kernel, per_call):
    """Eight flagship-shaped scenarios (45 x 45 samples, 30 steps, 512
    obstacle and 384 segment slots) through ``make_fleet_solver`` on the
    card and on the CPU: the same found, num_admissible and command (or
    a tie), the cost within rel 1e-4, and the backend's launches."""
    from kompass_core_tpu_torch.ops.window import sample_velocity_window
    from kompass_core_tpu_torch.parallel import make_fleet_solver

    spec = solver.SolverSpec(
        is_omni=False, n_vx=45, n_vy=1, n_omega=45, max_points=30,
        num_ctrl_points=6, scan_size=512, seg_size=384, backend=backend,
    )
    rng = np.random.default_rng(1)
    limits = np.array([1.0, 5.0, 10.0, 0.0, 0.0, 0.0, 2.0, 3.0, 3.0])
    bufs = np.zeros((8, solver.packed_input_size(spec)), np.float32)
    for i in range(8):
        window = sample_velocity_window((0.5, 0.0, 0.1), limits, 0.1, 45, 1, 45,
                                        False)
        ang = np.linspace(-np.pi, np.pi, 512, endpoint=False)
        r = rng.uniform(2.5, 9.0, 512)
        obs = np.stack([r * np.cos(ang) + 0.1 * i, r * np.sin(ang)], 1)
        s = 0.01 * np.arange(301, dtype=np.float32)
        seg = [np.full(384, 1e8, np.float32) for _ in range(2)]
        arc = np.zeros(384, np.float32)
        seg[0][:301], seg[1][:301], arc[:301] = 0.1 * i + s, 0.1 * s * s, s
        params = np.array([0.1, 0.3, 0.05, 2.0, 1.0, 1.0, 0.1, 0.05, 5.0, 0.0,
                           3.0, 10 / 3], np.float32)
        solver.pack_solver_input(spec, bufs[i], params, (0.1 * i, 0.0, 0.0),
                                 window, obs, 512, seg[0], seg[1], arc, 301,
                                 3.0, 10.0, 30)
    counter = getattr(kernels, kernel)
    before = counter.launches
    out = make_fleet_solver(spec, cuda)(bufs).cpu().numpy()
    assert counter.launches == before + per_call
    ref = make_fleet_solver(spec, "cpu")(bufs).numpy()
    for o, c in zip(out, ref):
        assert o[0] == c[0] and o[3] == c[3] and o[0] == 1.0
        np.testing.assert_allclose(o[1], c[1], rtol=1e-4)
        if o[2] == c[2]:
            np.testing.assert_allclose(o[4:], c[4:], rtol=1e-5, atol=1e-5)
        else:
            assert abs(o[1] - c[1]) <= 1e-6 * abs(c[1])


# --- the static kernel (K1, K2, K4, K6): several samples of one step per thread ---


def _one_field(fn):
    """K4 (or its plain version) with the fused sweeps' arguments: its one
    field over the obstacle rows, as a 1-tuple."""
    def call(px, py, obs, sx, sy, ap, **kw):
        return (fn(px, py, obs, ap, **kw),)
    return call


# (wrapper with the fused sweeps' arguments, its plain version, its launch
# counter)
_STATIC = {
    "K1": (kernels.fused_min_dist_sq, kernels.fused_min_dist_sq_reference,
           kernels.fused_min_dist_sq),
    "K2": (kernels.fused_min_dist_sq_expanded,
           kernels.fused_min_dist_sq_expanded_reference,
           kernels.fused_min_dist_sq_expanded),
    "K4": (_one_field(kernels.min_dist_sq_expanded),
           _one_field(kernels.min_dist_sq_expanded_reference),
           kernels.min_dist_sq_expanded),
    "K6": (kernels.fused_min_dist_sq_broadcast,
           kernels.fused_min_dist_sq_broadcast_reference,
           kernels.fused_min_dist_sq_broadcast),
}


def _nan_equal(got, want):
    """Each pair equal bit for bit, NaN where the other has NaN."""
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        g, w = (torch.where(v.isnan(), 0.0, v) for v in (g, w))
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("name", sorted(_STATIC))
@pytest.mark.parametrize("points", kernels.STATIC_POINTS)
@pytest.mark.parametrize(
    "B,S,T,O,G,active",
    [(1, 2025, 30, 512, 384, 30), (1, 2025, 30, 512, 384, 17),
     (64, 2025, 30, 512, 384, None),  # mixed active steps
     (2, 1025, 7, 512, 384, 5),       # S past one block's samples
     (1, 2025, 30, 1100, 1025, 30),   # rows past one tile
     (1, 1000, 40, 1, 1024, 40),      # the cost evaluator's rows
     (3, 2025, 1, 512, 384, 1)],      # T = 1
)
def test_static_kernels_at_every_points_per_thread(cuda, name, points, B, S, T, O,
                                                   G, active):
    """K1, K2, K4 and K6 equal their plain versions at every number of
    samples per thread the launch can take, forced through the wrapper;
    pad rows included."""
    kernel, plain, counter = _STATIC[name]
    px, py, obs, _, _, sx, sy = _moving_case(S + O + B + points, B, S, T, O, G, cuda)
    obs[:, -3:] = 1e8
    if active is None:
        ap = torch.randint(1, T + 1, (B,), generator=torch.Generator().manual_seed(B),
                           dtype=torch.int32).to(cuda)
    else:
        ap = torch.full((B,), active, dtype=torch.int32, device=cuda)
    want = plain(px, py, obs, sx, sy, ap)
    before = counter.launches
    got = kernel(px, py, obs, sx, sy, ap, _points=points)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(_STATIC))
def test_static_kernels_keep_nan_and_inf(cuda, name):
    """NaN and +-inf in robot 0's points and rows, robot 1 finite (the
    fminf path), robot 2 one NaN obstacle row in its second tile, robot 3
    values above 1e18 (the flag of K2, K4 and K6) and a point against a
    row that makes the broadcast pair inf - inf: at the launch's own
    samples per thread and at each the kernel takes."""
    kernel, plain, _ = _STATIC[name]
    px, py, obs, _, _, sx, sy = _moving_case(13, 4, 300, 30, 1100, 384, cuda)
    nan, inf = float("nan"), float("inf")
    px[0, 3, 4], py[0, 7, 0], px[0, 11, 29] = nan, inf, -inf
    obs[0, 5, 0], obs[0, 9, 1], obs[0, 1050] = nan, inf, -inf
    sx[0, 2], sy[0, 4] = nan, -inf
    obs[2, 1060, 1] = nan
    obs[3, 6] = torch.tensor([1.7e19, 0.0])
    px[3, 3, 3], py[3, 3, 3], sx[3, 0] = 1.06e19, 0.0, 5e18
    obs[3, 9] = torch.tensor([1.5e19, -1.5e19])
    px[3, 7, 2], py[3, 7, 2] = 1.2e19, 1.2e19
    ap = torch.tensor([30, 30, 30, 17], dtype=torch.int32, device=cuda)
    want = plain(px, py, obs, sx, sy, ap)
    for points in (None, *kernels.STATIC_POINTS):
        _nan_equal(kernel(px, py, obs, sx, sy, ap, _points=points), want)
    assert not bool(want[0][1].isnan().any()) and bool(want[0][2].isnan().all())
    assert bool(want[0][3, 7, 2].isnan()) == (name == "K6")


@pytest.mark.parametrize("name", sorted(_STATIC))
def test_refused_static_launch_raises(cuda, name):
    """Samples per thread the kernel is not built for are refused by the
    C entry point and raised, not run another way."""
    kernel, _, counter = _STATIC[name]
    px, py, obs, sx, sy = _case(14, 64, 10, 256, 128, cuda)
    ap = torch.tensor(10, dtype=torch.int32, device=cuda)
    seg = (None, None) if name == "K4" else (sx, sy)
    dims = kernels._check_sweep(name, px, py, obs, *seg, ap)
    with pytest.raises(RuntimeError, match="cudaError"):
        kernels._launch(f"kompass_{counter.__name__}", dims, px, py, obs, *seg, ap,
                        points=(4,))
    before = counter.launches
    with pytest.raises(ValueError, match="samples per thread"):
        kernel(px, py, obs, sx, sy, ap, _points=4)
    assert counter.launches == before


# --- K6, K7, K8 and the k-tick loop's CUDA graph ---------------------------------

_TPU_FORMS = {
    "K6": (kernels.fused_min_dist_sq_broadcast,
           kernels.fused_min_dist_sq_broadcast_reference, False),
    "K7": (kernels.fused_min_dist_sq_moving_expanded,
           kernels.fused_min_dist_sq_moving_expanded_reference, True),
    "K8": (kernels.fused_min_dist_sq_moving_broadcast,
           kernels.fused_min_dist_sq_moving_broadcast_reference, True),
}


@pytest.mark.parametrize("name", sorted(_TPU_FORMS))
@pytest.mark.parametrize(
    "B,S,T,O,G,active",
    [(1, 2025, 30, 512, 384, 30), (3, 37, 7, 700, 333, 5),
     (2, 1025, 30, 1100, 1025, 17), (3, 1023, 1, 768, 384, 1),
     (8, 2025, 30, 768, 384, 30)],
)
def test_tpu_form_kernels_bit_identical_to_plain(cuda, name, B, S, T, O, G, active):
    """K6, K7 and K8 equal their plain versions: pad rows, ragged S,
    rows past one tile, T = 1."""
    kernel, plain, moving = _TPU_FORMS[name]
    px, py, obs, vel, dt, sx, sy = _moving_case(S + O + G + B, B, S, T, O, G, cuda)
    obs[:, -5:], vel[:, -5:] = 1e8, 0.0
    ap = torch.full((B,), active, dtype=torch.int32, device=cuda)
    args = (px, py, obs, vel, dt, sx, sy, ap) if moving else (px, py, obs, sx, sy, ap)
    before = kernel.launches
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool(torch.isinf(g[..., active:]).all())
        assert bool((g[..., :active] >= 0).all())


@pytest.mark.parametrize("name", sorted(_TPU_FORMS))
def test_tpu_form_kernels_keep_nan_and_inf(cuda, name):
    """NaN and +-inf in robot 0's points, rows, velocities and segment
    rows; robot 1 finite (the fminf path); robot 2 one NaN row in its
    second tile."""
    kernel, plain, moving = _TPU_FORMS[name]
    px, py, obs, vel, dt, sx, sy = _moving_case(11, 3, 300, 30, 1100, 384, cuda)
    nan, inf = float("nan"), float("inf")
    px[0, 3, 4], py[0, 7, 0], px[0, 11, 29] = nan, inf, -inf
    obs[0, 5, 0], obs[0, 9, 1], obs[0, 1050] = nan, inf, -inf
    vel[0, 17, 1] = inf
    sx[0, 2], sy[0, 4] = nan, -inf
    obs[2, 1060, 1] = nan
    ap = torch.full((3,), 30, dtype=torch.int32, device=cuda)
    args = (px, py, obs, vel, dt, sx, sy, ap) if moving else (px, py, obs, sx, sy, ap)
    got, want = kernel(*args), plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    assert not bool(got[0][1].isnan().any()) and bool(got[0][2].isnan().all())


def test_k8_at_zero_velocity_equals_k6_and_segments_are_k2_k6(cuda):
    px, py, obs, vel, dt, sx, sy = _moving_case(12, 4, 2025, 30, 768, 384, cuda)
    ap = torch.tensor([30, 17, 2, 30], dtype=torch.int32, device=cuda)
    zero = torch.zeros_like(vel)
    k6 = kernels.fused_min_dist_sq_broadcast(px, py, obs, sx, sy, ap)
    k8 = kernels.fused_min_dist_sq_moving_broadcast(px, py, obs, zero, dt, sx, sy, ap)
    assert torch.equal(k8[0], k6[0]) and torch.equal(k8[1], k6[1])
    k2 = kernels.fused_min_dist_sq_expanded(px, py, obs, sx, sy, ap)
    k7 = kernels.fused_min_dist_sq_moving_expanded(px, py, obs, vel, dt, sx, sy, ap)
    assert torch.equal(k7[1], k2[1])
    k7z = kernels.fused_min_dist_sq_moving_expanded(px, py, obs, zero, dt, sx, sy, ap)
    torch.testing.assert_close(k7z[0], k2[0], rtol=2e-4, atol=1e-4)


def _small_fleet(device, tracked, **kw):
    from kompass_core_tpu_torch.control import DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )

    robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.2, 0.4])) for _ in range(4)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=6.0, max_decel=6.0),
    )
    config = DWAConfig(max_linear_samples=12, max_angular_samples=12,
                       prediction_horizon=20, control_horizon=2)
    fleet = DeviceFleet(robots, limits, config, 128, path_capacity=1024,
                        max_segments=16, tracked_obstacles=tracked, device=device, **kw)
    fleet.set_paths([np.array([[0.0, 2.0 * i], [6.0, 2.0 * i]]) for i in range(4)])
    rng = np.random.default_rng(3)
    states = np.zeros((4, 4), np.float32)
    states[:, 0] = 0.0137
    states[:, 1] = 2.0 * np.arange(4)
    vels = np.tile(np.float32([0.4, 0.0, 0.1]), (4, 1))
    ranges = rng.uniform(0.8, 10.0, (4, 128)).astype(np.float32)
    angles = np.linspace(-np.pi, np.pi, 128, endpoint=False)
    trk = None
    if tracked:
        trk = np.full((4, tracked, 4), np.nan, np.float32)
        trk[:, 0] = (2.0, 1.0, 0.0, -0.6)
        trk[:, 0, 1] += states[:, 1]
    return fleet, (states, vels, ranges, angles, trk)


@pytest.mark.parametrize("tracked", [0, 2])
def test_k_tick_graph_replay_equals_the_eager_loop(cuda, tracked):
    """``run_ticks_on_device`` on the card replays one captured graph per
    k: bit for bit the eager loop's outputs, carry and final states; a
    second call replays without capturing; new paths capture anew; and
    the card agrees with the CPU run of the same loop."""
    from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS

    fleet, inputs = _small_fleet(cuda, tracked)
    carry0 = [t.clone() for t in fleet._carry]
    fleet._prepare_tick_inputs(*inputs)
    dev_inputs = torch.tensor(fleet._inputs, device=cuda)
    eager = fleet.ticks_fn(6)(fleet._paths, fleet._cfg,
                              type(fleet._carry)(*carry0), fleet._angles,
                              dev_inputs)
    before = kernels.launch_counts()
    out = fleet.run_ticks_on_device(6, *inputs[:4], tracked=inputs[4])
    graph = fleet.tick_graphs[6]
    assert kernels.launch_counts() != before  # the warm-up and the capture
    for i, f in enumerate(OUT_FIELDS):
        np.testing.assert_array_equal(out[f].astype(np.float32),
                                      eager[1][:4, :, i].cpu().numpy(), err_msg=f)
    np.testing.assert_array_equal(out["final_states"], eager[2][:4].cpu().numpy())
    for a, b in zip(fleet._carry, eager[0]):
        assert torch.equal(a, b)
    before = kernels.launch_counts()
    fleet.run_ticks_on_device(6, *inputs[:4], tracked=inputs[4])
    # replayed, not captured again: no wrapper was called
    assert fleet.tick_graphs[6] is graph and kernels.launch_counts() == before
    fleet.set_paths([np.array([[0.0, 2.0 * i], [5.0, 2.0 * i]]) for i in range(4)])
    fleet.run_ticks_on_device(6, *inputs[:4], tracked=inputs[4])
    assert fleet.tick_graphs[6] is not graph
    cpu, _ = _small_fleet("cpu", tracked)
    card, _ = _small_fleet(cuda, tracked)
    got = card.run_ticks_on_device(4, *inputs[:4], tracked=inputs[4])
    want = cpu.run_ticks_on_device(4, *inputs[:4], tracked=inputs[4])
    for key in ("found", "reached", "num_admissible", "active_points"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)
    np.testing.assert_allclose(got["final_states"], want["final_states"],
                               rtol=1e-5, atol=1e-6)


# --- the emergency stop, the safety gate and peers (items 5c, 5d) -------------


def test_critical_zone_checker_on_card_matches_cpu(cuda):
    """The checker on the card equals the CPU bit for bit: 360-ray scans
    with NaN and inf returns, beams at the critical and at the slowdown
    distance, a centered and a translated, rotated sensor and the
    360-degree cone, both directions."""
    import math

    from kompass_core_tpu_torch.ops import critical_zone as cz

    rng = np.random.default_rng(4)
    angles = np.linspace(0, 2 * np.pi, 360, endpoint=False)
    for cone, pos, yaw in ((160.0, (0.0, 0.0), 0.0), (120.0, (0.1, -0.05), 0.7),
                           (360.0, (0.0, 0.0), 0.0)):
        spec = cz.build_critical_zone("CYLINDER", [0.3, 0.4], [*pos, 0.0],
                                      [0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2)],
                                      cone, 0.3, 0.6, angles)
        checks = [cz.get_critical_zone_checker(spec, d) for d in (cuda, "cpu")]
        for case in range(6):
            ranges = rng.uniform(0.35, 2.0, 360).astype(np.float32)
            ranges[rng.random(360) < 0.05] = np.nan
            ranges[7] = np.inf
            if case % 3 == 1:
                ranges[::9] = np.float32(0.6)  # radius + critical distance
            elif case % 3 == 2:
                ranges = np.maximum(ranges, 0.9)  # radius + slowdown distance
                ranges[::9] = np.float32(0.9)
            for forward in (True, False):
                got, want = (check(ranges, forward) for check in checks)
                assert got.device.type == "cuda"
                assert torch.equal(got.cpu(), want), (cone, case, forward)


def _peer_inputs(inputs):
    """_small_fleet's inputs with one return 0.55 m ahead of each robot
    (inside the slowdown band of the default zone)."""
    states, vels, ranges, angles, trk = inputs
    ranges = ranges.copy()
    ranges[:, 64] = 0.55  # angle 0 of the [-pi, pi) grid
    return states, vels, ranges, angles, trk


@pytest.mark.parametrize("predict,kernel", [(False, "K1"), (True, "K3")])
def test_peer_safety_fleet_tick_on_card_matches_cpu(cuda, predict, kernel):
    """Four robots with peers (with and without prediction) and the safety
    gate: the tick on the card and on the CPU gives the same found,
    num_admissible and safety factor, the command (or a tie) and the cost
    within rel 1e-4; one sweep launch, static without prediction."""
    from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig

    kw = dict(peer_avoidance=True, peer_prediction=predict,
              safety_config=FleetSafetyConfig())
    (gpu_fleet, inputs), (cpu_fleet, _) = (_small_fleet(d, 0, **kw) for d in (cuda, "cpu"))
    inputs = _peer_inputs(inputs)
    before = kernels.launch_counts()
    gpu, cpu = (f.tick(*inputs[:4]) for f in (gpu_fleet, cpu_fleet))
    made = {k: c - before[k] for k, c in kernels.launch_counts().items() if c != before[k]}
    assert made == {kernel: 1}
    for key in ("found", "reached", "num_admissible", "active_points", "safety_factor"):
        np.testing.assert_array_equal(gpu[key], cpu[key], err_msg=key)
    assert (gpu["safety_factor"] < 1.0).all()
    np.testing.assert_allclose(gpu["cost"], cpu["cost"], rtol=1e-4)
    cmd_g = np.stack([gpu[k] for k in ("vx", "vy", "omega")], 1)
    cmd_c = np.stack([cpu[k] for k in ("vx", "vy", "omega")], 1)
    for r in np.flatnonzero((cmd_g != cmd_c).any(1)):
        assert abs(gpu["cost"][r] - cpu["cost"][r]) <= 1e-6 * abs(cpu["cost"][r]), r


def test_k_tick_graph_replay_with_peers_and_safety(cuda):
    """The peer, prediction and safety k-tick loop on the card: the
    replayed graph equals the eager loop bit for bit, and the card agrees
    with the CPU run of the same loop."""
    from kompass_core_tpu_torch.ops.fleet_solver import OUT_FIELDS
    from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig

    kw = dict(peer_avoidance=True, peer_prediction=True,
              safety_config=FleetSafetyConfig())
    fleet, inputs = _small_fleet(cuda, 2, **kw)
    inputs = _peer_inputs(inputs)
    carry0 = [t.clone() for t in fleet._carry]
    fleet._prepare_tick_inputs(*inputs)
    eager = fleet.ticks_fn(6)(fleet._paths, fleet._cfg, type(fleet._carry)(*carry0),
                              fleet._angles, torch.tensor(fleet._inputs, device=cuda),
                              fleet._safety)
    out = fleet.run_ticks_on_device(6, *inputs[:4], tracked=inputs[4])
    for i, f in enumerate(OUT_FIELDS):
        np.testing.assert_array_equal(out[f].astype(np.float32),
                                      eager[1][:4, :, i].cpu().numpy(), err_msg=f)
    np.testing.assert_array_equal(out["final_states"], eager[2][:4].cpu().numpy())
    assert (out["safety_factor"] < 1.0).any()
    cpu, _ = _small_fleet("cpu", 2, **kw)
    card, _ = _small_fleet(cuda, 2, **kw)
    got = card.run_ticks_on_device(4, *inputs[:4], tracked=inputs[4])
    want = cpu.run_ticks_on_device(4, *inputs[:4], tracked=inputs[4])
    for key in ("found", "reached", "num_admissible", "active_points"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)
    np.testing.assert_allclose(got["safety_factor"], want["safety_factor"], atol=1e-6)
    np.testing.assert_allclose(got["final_states"], want["final_states"],
                               rtol=1e-5, atol=1e-6)


# --- K3s and K9 (the split movers and BOX robots) --------------------------------


def _box_args(seed, B, S, T, O, device, moving):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, scale=10.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(device)

    yaw = u(B, S, T, scale=3.2)
    half = (torch.rand(B, 2, generator=g) * 0.5).to(device)
    half[0] = 0.0  # a circle robot's (0, 0) box
    vel = u(B, O, 2, scale=1.5) if moving else None
    dt = torch.full((B,), 0.1, device=device)
    return [u(B, S, T), u(B, S, T), torch.cos(yaw), torch.sin(yaw), u(B, O, 2),
            vel, dt, half]


@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("points", [None, 2, 8])
@pytest.mark.parametrize("B,S,T,O", [(1, 2025, 30, 512), (3, 37, 7, 1100), (2, 300, 1, 5)])
def test_k9_bit_identical_to_plain(cuda, moving, points, B, S, T, O):
    """K9 against its plain version: per-robot extents, a row inside a
    footprint, pad rows, mixed active steps, at each kPts."""
    args = _box_args(B * 31 + O, B, S, T, O, cuda, moving)
    px, py, obs = args[0], args[1], args[4]
    obs[0, 0] = torch.stack([px[0, 0, 0], py[0, 0, 0]])
    if moving:
        args[5][0, 0] = 0.0
    obs[:, -1] = 1e8
    ap = torch.tensor([T] + [max(1, T // 2)] * (B - 1), dtype=torch.int32, device=cuda)
    before = kernels.box_min_dist_sq.launches
    got = kernels.box_min_dist_sq(*args, ap, _points=points)
    want = kernels.box_min_dist_sq_reference(*args, ap)
    torch.cuda.synchronize()
    assert kernels.box_min_dist_sq.launches == before + 1
    assert torch.equal(got, want)
    assert float(got[0, 0, 0]) == 0.0


def test_k9_keeps_a_nan_row(cuda):
    args = _box_args(5, 2, 200, 6, 40, cuda, False)
    args[4][1, 3, 0] = float("nan")
    ap = torch.tensor([6, 6], dtype=torch.int32, device=cuda)
    got = kernels.box_min_dist_sq(*args, ap)
    want = kernels.box_min_dist_sq_reference(*args, ap)
    assert bool(got[1].isnan().all()) and not bool(got[0].isnan().any())
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("M", [1, 8, 1100])
def test_k3s_bit_identical_to_plain_and_to_k3(cuda, M):
    g = torch.Generator().manual_seed(M)
    B, S, T = 4, 2025, 30

    def u(*shape, scale=10.0):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).to(cuda)

    px, py, rows, vel = u(B, S, T), u(B, S, T), u(B, M, 2), u(B, M, 2, scale=1.5)
    dt = torch.full((B,), 0.1, device=cuda)
    ap = torch.tensor([30, 17, 1, 30], dtype=torch.int32, device=cuda)
    seg = u(B, 16)
    before = kernels.min_dist_sq_moving.launches
    got = kernels.min_dist_sq_moving(px, py, rows, vel, dt, ap)
    torch.cuda.synchronize()
    assert kernels.min_dist_sq_moving.launches == before + 1
    assert torch.equal(got, kernels.min_dist_sq_moving_reference(px, py, rows, vel, dt, ap))
    k3 = kernels.fused_min_dist_sq_moving(px, py, rows, vel, dt, seg, seg, ap)[0]
    assert torch.equal(got, k3)


@pytest.mark.parametrize("form", ["split", "box"])
def test_split_and_box_fleet_tick_on_card_matches_cpu(cuda, form):
    """A small split or mixed BOX fleet: the card's tick agrees with the
    CPU's (the solver tolerances) and launches K3s or K9."""
    from kompass_core_tpu_torch.control import DWAConfig
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits, RobotGeometry,
        RobotType,
    )

    def robots():
        return [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                      geometry_type=RobotGeometry.Type.BOX if (form == "box" and i == 1)
                      else RobotGeometry.Type.CYLINDER,
                      geometry_params=np.array([0.5, 0.3, 0.4] if (form == "box" and i == 1)
                                               else [0.2, 0.4]))
                for i in range(3)]

    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=2.0, max_acc=3.0, max_decel=3.0))
    config = DWAConfig(max_linear_samples=10, max_angular_samples=10,
                       prediction_horizon=20, control_horizon=2)
    fleets = [DeviceFleet(robots(), limits, config, 64, path_capacity=512,
                          max_segments=8, tracked_obstacles=2,
                          split_mover_sweep=form == "split", device=dev)
              for dev in (cuda, "cpu")]
    key = "K3s" if form == "split" else "K9"
    wrapper = kernels.SWEEP_KERNELS[key]
    rng = np.random.default_rng(1)
    ranges = rng.uniform(0.8, 10.0, (3, 64)).astype(np.float32)
    angles = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    trk = np.full((3, 2, 4), np.nan, np.float32)
    trk[:, 0] = (2.0, 1.0, 0.0, -0.5)
    states = np.zeros((3, 4), np.float32)
    states[:, 1] = 3.0 * np.arange(3)
    outs = []
    for fleet in fleets:
        fleet.set_paths([np.array([[0.0, 3.0 * i], [5.0, 3.0 * i]]) for i in range(3)])
        before = wrapper.launches
        outs.append(fleet.tick(states, np.zeros((3, 3)), ranges, angles, tracked=trk))
        assert wrapper.launches == before + (1 if fleet.device.type == "cuda" else 0)
    gpu, cpu = outs
    for k in ("found", "num_admissible", "active_points"):
        np.testing.assert_array_equal(gpu[k], cpu[k])
    np.testing.assert_allclose(gpu["cost"], cpu["cost"], rtol=1e-4, atol=1e-6)
