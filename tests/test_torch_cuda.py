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
     (1, 2, 1, 1, 2), (300, 30, 4096, 64, 30)],
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


def test_local_mapper_bayesian_update_on_card_matches_cpu(cuda):
    """One Bayesian LocalMapper update at the full 400 x 400 / 3600 size on
    the card equals the same update on the CPU, with one K5 launch."""
    from kompass_core_tpu.datatypes import LaserScanData
    from kompass_core_tpu.datatypes.pose import PoseData
    from kompass_core_tpu.datatypes.scan_model import ScanModelConfig
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
