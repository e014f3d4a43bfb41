"""The port's large-capture solvers on the card against its CPU path: the
PCG and dense BA camera solves on a 64-camera ring, their repeatability,
frozen cameras whose preconditioner blocks are zero, and the PCG pose
graph. Every test needs an
NVIDIA GPU (marker `cuda`) and skips without one. The module imports no
JAX, so on the GPU machine it runs without the repository's conftest:

    python -m pytest tests/test_torch_cuda_pcg.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sphericalsfm_tpu_torch.eval.synthetic import make_ring_scene
from sphericalsfm_tpu_torch.interop import rotation_graph_from_numpy
from sphericalsfm_tpu_torch.optim import ba
from sphericalsfm_tpu_torch.optim.pose_graph import (
    initialize_rotations_sequential, optimize_rotations,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: this checks the solvers on the card")
    return torch.device("cuda")


def _to(p, dev):
    return ba.BAProblem(*(t.to(dev) if t is not None else None for t in p))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["pcg", "dense"])
def test_ba_on_cuda_matches_cpu(cuda, solver):
    """64 cameras, float64: the card's run (index_add_ atomics reorder the
    sums) lands on the CPU run's cost to rtol 1e-6."""
    p = make_ring_scene(C=64, W=40, P=640, dtype=np.float64, device="cpu")
    kw = dict(camera_solver=solver, max_iters=10, ftol=1e-12, pcg_iters=25, pcg_rtol=1e-2)
    r_cpu = ba.bundle_adjust(p, **kw)
    r_gpu = ba.bundle_adjust(_to(p, cuda), **kw)
    assert r_gpu.cost.device.type == "cuda"
    assert float(r_cpu.cost) < 0.5 * float(r_cpu.initial_cost)
    np.testing.assert_allclose(float(r_gpu.cost), float(r_cpu.cost), rtol=1e-6)
    np.testing.assert_allclose(r_gpu.cam_r.cpu().numpy(), r_cpu.cam_r.numpy(), atol=1e-6)


@pytest.mark.cuda
def test_pcg_on_cuda_repeats_bit_for_bit(cuda):
    """The BA's sums are sorted segment sums, not atomics: two float32 PCG
    runs on the card give the same bits."""
    p = make_ring_scene(C=64, W=40, P=640, device=cuda)
    kw = dict(camera_solver="pcg", max_iters=8, ftol=1e-12, solve_dtype_name="float32",
              pcg_iters=25, pcg_rtol=1e-2)
    a, b = ba.bundle_adjust(p, **kw), ba.bundle_adjust(p, **kw)
    assert float(a.cost) < 0.5 * float(a.initial_cost)
    assert torch.equal(a.cam_r, b.cam_r) and torch.equal(a.points, b.points)
    assert float(a.cost) == float(b.cost) and a.pcg_iterations == b.pcg_iterations


@pytest.mark.cuda
def test_pcg_frozen_cameras_on_cuda(cuda):
    """Cameras 10–19 frozen, λ = 0, float32: their Schur blocks are exact
    zeros, the block-Jacobi factors stay finite, their step is exactly
    zero, and the whole step is finite. An indefinite and a zero block on
    the card take the fallback factor without NaN."""
    p = make_ring_scene(C=64, W=40, P=640, device=cuda)
    rot_fixed = p.rot_fixed.clone()
    rot_fixed[10:20] = True
    p, _ = ba.prepare_problem(p._replace(rot_fixed=rot_fixed), "pcg")
    lam = torch.zeros((), dtype=torch.float32, device=cuda)
    rs = ba._assemble_reduced(p.focal, p.cam_t, p.cam_r, p.points, p, lam, 1.0, torch.float32)
    frozen = rs.Hcc_d[10:20] - rs.Mcc[10:20]
    assert bool((frozen == 0).all())
    L = ba._jacobi_factor(rs.Hcc_d - rs.Mcc, rs.Hcc_d, 1e-6)
    assert bool(torch.isfinite(L).all())
    _, d_cam, d_pts, md, n_cg = ba._pcg_from_rs(rs, p, lam, torch.float32, 25, 1e-2)
    assert n_cg > 0 and bool(torch.isfinite(d_cam).all()) and bool(torch.isfinite(d_pts).all())
    assert bool((d_cam[10:20] == 0).all()) and float(md) > 0
    eye6 = torch.eye(6, device=cuda)
    L2 = ba._jacobi_factor(torch.stack([-eye6, torch.zeros_like(eye6)]),
                           torch.stack([2 * eye6, torch.zeros_like(eye6)]), 1e-6)
    assert bool(torch.isfinite(L2).all())
    torch.testing.assert_close(L2[0] @ L2[0].T, 2 * eye6, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_pose_graph_pcg_on_cuda_matches_cpu(cuda):
    """A 450-frame ring with loop closures: "auto" takes the PCG on both
    devices, and the rotations agree to 1e-6."""
    n = 450
    rng = np.random.default_rng(0)
    phi = np.arange(n) * 2 * np.pi / n
    pairs = [(i, i + 1) for i in range(n - 1)] + [(i, i + n // 2) for i in range(0, n // 2, 45)]
    ei = np.array([a for a, _ in pairs])
    ej = np.array([b for _, b in pairs])
    r_meas = np.stack([np.zeros(len(pairs)), phi[ej] - phi[ei], np.zeros(len(pairs))], -1)
    r_meas = r_meas + rng.normal(size=r_meas.shape) * 0.003
    out = {}
    for dev in ("cpu", cuda):
        g = rotation_graph_from_numpy(ei, ej, r_meas, np.ones(len(pairs)), device=dev)
        before = optimize_rotations.solves["pcg"]
        rots, cost = optimize_rotations(initialize_rotations_sequential(n, g), g, max_iters=20)
        assert optimize_rotations.solves["pcg"] == before + 1
        out[str(dev)] = (rots.cpu().numpy(), float(cost))
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-6)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-6)
