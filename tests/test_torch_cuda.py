"""The port's CUDA kernel against its plain version, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device (the
decision is taken inside the test, never at import). Run on a GPU host
with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from kompass_core_tpu_torch.ops import kernels, solver

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
