"""The port's long-capture path against the JAX package and plain
references, on the CPU at small sizes: windows matching's pair set,
rotation averaging on the PCG against JAX's PCG and against
`sfmbench/reference/rotations.py`, bundle adjustment on the PCG against
JAX's PCG and the benchmark scorer's `ba_gain`, and the spans and counters
of both solvers (`tracing`)."""

import os
import sys
from collections import Counter
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphericalsfm_tpu.optim import ba as jba
from sphericalsfm_tpu.optim import pose_graph as jpg
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log
from sphericalsfm_tpu_torch.interop import ba_problem_from_numpy, rotation_graph_from_numpy
from sphericalsfm_tpu_torch.optim import ba as tba
from sphericalsfm_tpu_torch.optim import pose_graph as tpg
from sphericalsfm_tpu_torch.pipeline.frontend import window_pairs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from sfmbench.reference import rotations as ref_rot  # noqa: E402
from sfmbench.reference.score import ba_gain  # noqa: E402

# The port's PCG rotations and cost against the plain reference's dense LM
# on the same graph from the same start. Both stop at a relative decrease
# under 1e-12, so near the common minimum they read the same cost to about
# that (read here: 1e-15) and rotations within about 1e-6 degrees (read:
# 6.6e-7). The reference computed in float32 lands 5e-10 off in cost and
# 3.6e-5 degrees off in rotation: each tolerance fails it.
COST_RTOL = 1e-11
ANGLE_DEG = 1e-5
FOCAL = 500.0


@pytest.mark.parametrize("frames, pairs", [(540, 2514), (505, 2409), (48, 918)])
def test_window_pairs_equal_the_plain_set(frames, pairs):
    """The band j − i ≤ 3 and the 30 × 30 begin/end loop windows (skipping
    adjacent frames), each pair once, in (i, j) order."""
    ei, ej = window_pairs(frames, 3, 30, 30)
    plain = {(i, j) for i in range(frames) for j in range(i + 1, frames)
             if j - i <= 3 or (i < 30 and j >= frames - 30 and j > i + 1)}
    got = list(zip(ei.tolist(), ej.tolist()))
    assert got == sorted(plain) and len(got) == pairs


def _ring_graph(N=420, seed=0, outliers=0.01, start_deg=0.5):
    """A ring of N cameras turning once about y, with the windows pairs'
    edges (band 3, 30 × 30 loop windows), 0.1° of measurement noise, a
    share of 0.2 rad outliers, 2% of edges dead, and a start 0.5° off the
    truth (node 0 on it)."""
    rng = np.random.default_rng(seed)
    ei, ej = window_pairs(N, 3, 30, 30)
    true = np.stack([0.01 * rng.normal(size=N), 2 * np.pi * np.arange(N) / N,
                     0.01 * rng.normal(size=N)], -1)
    R = np_so3_exp(true)
    rel = np.einsum("eij,ekj->eik", R[ej], R[ei])
    noise = np_so3_exp(rng.normal(size=(len(ei), 3)) * np.deg2rad(0.1))
    r_meas = np_so3_log(noise @ rel)
    bad = rng.uniform(size=len(ei)) < outliers
    r_meas[bad] = np_so3_log(np_so3_exp(rng.normal(size=(bad.sum(), 3)) * 0.2)
                             @ np_so3_exp(r_meas[bad]))
    w = (rng.uniform(size=len(ei)) >= 0.02).astype(float)
    rot0 = true + rng.normal(size=true.shape) * np.deg2rad(start_deg)
    rot0[0] = true[0]
    return torch.as_tensor(rot0), rotation_graph_from_numpy(ei, ej, r_meas, w)


def _max_angle_deg(a, b):
    Ra, Rb = np_so3_exp(a.double().numpy()), np_so3_exp(b.double().numpy())
    return float(np.degrees(np.linalg.norm(np_so3_log(np.einsum("nij,nkj->nik", Ra, Rb)),
                                           axis=-1)).max())


@pytest.fixture(scope="module")
def ring():
    rot0, g = _ring_graph()
    ref = ref_rot.optimize_rotations(rot0, g.edge_i, g.edge_j, g.r_meas, g.edge_w)
    return rot0, g, ref


def test_pcg_rotation_averaging_matches_the_plain_reference(ring):
    """420 nodes: "auto" takes the PCG; its rotations and cost land on the
    reference's dense LM, and its cost is the reference's cost function at
    its rotations."""
    rot0, g, ref = ring
    before = tpg.optimize_rotations.solves["pcg"]
    rots, cost, stats = tpg.optimize_rotations(rot0, g, return_counts=True)
    assert tpg.optimize_rotations.solves["pcg"] == before + 1
    assert stats["solver"] == "pcg" and 0 < stats["iterations"] < 64
    assert stats["pcg_iterations"] >= stats["iterations"]
    assert float(ref["cost"]) < 0.5 * float(ref["initial_cost"])
    assert abs(float(cost) - float(ref["cost"])) <= COST_RTOL * float(ref["cost"])
    assert _max_angle_deg(rots, ref["rotations"]) <= ANGLE_DEG
    at_port = ref_rot.cost(rots, g.edge_i, g.edge_j, g.r_meas, g.edge_w)
    np.testing.assert_allclose(float(at_port), float(cost), rtol=1e-13)


def test_pcg_rotation_averaging_matches_jax(ring):
    """The same 420-node graph and start through JAX's `optimize_rotations`
    on its PCG: the port lands on it within the reference tolerances (read:
    equal costs, 5.9e-9°), and JAX too lands on the reference."""
    rot0, g, ref = ring
    gj = jpg.RotationGraph(*(jnp.asarray(x.numpy()) for x in (g.edge_i, g.edge_j, g.r_meas,
                                                               g.edge_w)))
    rot_j, cost_j = jpg.optimize_rotations(jnp.asarray(rot0.numpy()), gj, solver="pcg")
    rot_j = torch.as_tensor(np.array(rot_j))
    rots, cost = tpg.optimize_rotations(rot0, g, solver="pcg")
    assert abs(float(cost) - float(cost_j)) <= COST_RTOL * float(cost_j)
    assert _max_angle_deg(rots, rot_j) <= ANGLE_DEG
    assert abs(float(cost_j) - float(ref["cost"])) <= COST_RTOL * float(ref["cost"])
    assert _max_angle_deg(rot_j, ref["rotations"]) <= ANGLE_DEG


def test_the_reference_in_float32_fails_the_tolerances(ring):
    """The comparison is tight enough to tell a float32 computation: the
    reference run in float32 misses the cost tolerance or the angle."""
    rot0, g, ref = ring
    r32 = ref_rot.optimize_rotations(rot0.float(), g.edge_i, g.edge_j, g.r_meas.float(),
                                     g.edge_w.float())
    assert r32["rotations"].dtype == torch.float32
    c32 = float(ref_rot.cost(r32["rotations"].double(), g.edge_i, g.edge_j, g.r_meas,
                             g.edge_w))
    off_cost = abs(c32 - float(ref["cost"])) > COST_RTOL * float(ref["cost"])
    off_angle = _max_angle_deg(r32["rotations"], ref["rotations"]) > ANGLE_DEG
    assert off_cost or off_angle


def test_the_reference_cost_is_the_programs():
    """At any rotations (here the start, outliers included) the reference
    reads the program's `pose_graph_cost`."""
    rot0, g = _ring_graph(N=60, seed=3, outliers=0.1)
    np.testing.assert_allclose(float(ref_rot.cost(rot0, g.edge_i, g.edge_j, g.r_meas, g.edge_w)),
                               float(tpg.pose_graph_cost(rot0, g)), rtol=1e-13)


def _ring_scene(C=16, P=240, seed=0, noise=0.5, outliers=0.03):
    """Cameras on a circle looking out at a shell of points, general mode:
    camera 0 held, the others' rotations and translations free, focal
    held; `noise` px and a share of 20 px outliers; points seen fewer than
    three times carry weight 0. Starts off the truth."""
    rng = np.random.default_rng(seed)
    cam_r = np.stack([np.zeros(C), np.arange(C) * 2 * np.pi / C, np.zeros(C)], -1)
    cam_t = np.tile([0.0, 0.0, -1.0], (C, 1))
    dirs = rng.normal(size=(P, 3))
    pts = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True) * rng.uniform(5.0, 9.0, (P, 1))
    pc = np.einsum("cij,pj->pci", np_so3_exp(cam_r), pts) + cam_t[None]
    vis = (pc[..., 2] > 1.0) & (np.abs(pc[..., :2] / pc[..., 2:3]) < 1.2).all(-1)
    obs_pt, obs_cam = np.nonzero(vis)
    uv = FOCAL * pc[obs_pt, obs_cam, :2] / pc[obs_pt, obs_cam, 2:]
    uv += rng.normal(size=uv.shape) * noise
    out = rng.uniform(size=len(uv)) < outliers
    uv[out] += rng.normal(size=(out.sum(), 2)) * 20
    w = (np.bincount(obs_pt, minlength=P)[obs_pt] >= 3).astype(float)
    fixed = np.arange(C) == 0
    r0 = cam_r + rng.normal(size=cam_r.shape) * 0.01
    t0 = cam_t + rng.normal(size=cam_t.shape) * 0.01
    r0[0], t0[0] = cam_r[0], cam_t[0]
    return SimpleNamespace(
        focal=FOCAL, cam_t=t0, cam_r=r0, points=pts + rng.normal(size=pts.shape) * 0.1,
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv, obs_w=w, focal_fixed=True, rot_fixed=fixed,
        trans_fixed=fixed, point_fixed=np.zeros(P, bool))


def test_pcg_bundle_adjust_ends_at_a_minimum_of_the_stated_cost():
    """The PCG camera solve run to its stopping rule leaves the written
    model where the scorer's one Gauss-Newton step of the stated Cauchy
    cost predicts a relative decrease under 1e-9 (the benchmark's limits
    sit at 2e-7; the start reads far above)."""
    s = _ring_scene()
    p = ba_problem_from_numpy(s)
    res = tba.bundle_adjust(p, max_iters=200, ftol=1e-12, camera_solver="pcg")
    assert res.pcg_iterations > 0 and float(res.cost) < 0.5 * float(res.initial_cost)
    live = s.obs_w > 0

    def gain(cam_r, cam_t, points):
        return ba_gain(np.asarray(cam_r), np.asarray(cam_t), FOCAL, False, s.obs_cam[live],
                       s.obs_pt[live], s.obs_uv[live], np.asarray(points))

    assert gain(res.cam_r, res.cam_t, res.points) < 1e-9
    assert gain(s.cam_r, s.cam_t, s.points) > 1e-3


def test_pcg_bundle_adjust_matches_jax():
    """The ring scene through JAX's `bundle_adjust` on its PCG camera solve:
    the same LM steps, the cost to 1e-11 relative (read: 1.2e-14) and the
    cameras and points to 1e-8 (read: 1.5e-10 translation, 7.3e-10 points),
    the bounds of the port's small-scene PCG parity test; roundoff in the
    CG's reductions differs, nothing else."""
    s = _ring_scene()
    track_obs, track_mask = jba.build_tracks(s.obs_pt, s.points.shape[0])
    pj = jba.BAProblem(
        focal=jnp.asarray(s.focal), cam_t=jnp.asarray(s.cam_t), cam_r=jnp.asarray(s.cam_r),
        points=jnp.asarray(s.points), obs_cam=jnp.asarray(s.obs_cam.astype(np.int32)),
        obs_pt=jnp.asarray(s.obs_pt.astype(np.int32)), obs_uv=jnp.asarray(s.obs_uv),
        obs_w=jnp.asarray(s.obs_w), track_obs=jnp.asarray(track_obs),
        track_mask=jnp.asarray(track_mask & (s.obs_w[track_obs] > 0)),
        focal_fixed=jnp.asarray(s.focal_fixed), rot_fixed=jnp.asarray(s.rot_fixed),
        trans_fixed=jnp.asarray(s.trans_fixed), point_fixed=jnp.asarray(s.point_fixed))
    kw = dict(max_iters=200, ftol=1e-12, camera_solver="pcg")
    rj = jba.bundle_adjust(pj, **kw)
    rp = tba.bundle_adjust(ba_problem_from_numpy(s), **kw)
    assert rp.pcg_iterations > 0 and int(rp.iterations) == int(rj.iterations)
    assert abs(float(rp.cost) - float(rj.cost)) <= 1e-11 * float(rj.cost)
    for name in ("cam_r", "cam_t", "points"):
        np.testing.assert_allclose(getattr(rp, name).numpy(), np.asarray(getattr(rj, name)),
                                   atol=1e-8, err_msg=name)


def _annotations(prof):
    return [e for e in prof.events() if e.name.split(":")[0] in ("stage", "call")]


def _leaves_never_nest(events):
    leaves = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name.startswith("stage:"))
    return all(b[0] >= a[1] for a, b in zip(leaves, leaves[1:]))


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pose_graph_spans_count_its_iterations(solver):
    """Each LM iteration is one `call:pose_graph.iteration` holding one
    `stage:pose_graph.solve` and one `stage:pose_graph.step`, on either
    solver; the leaves never nest; the counts are the stats'."""
    rot0, g = _ring_graph(N=60, seed=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, _, stats = tpg.optimize_rotations(rot0, g, solver=solver, return_counts=True)
    events = _annotations(prof)
    names = Counter(e.name for e in events)
    assert stats["solver"] == solver and stats["iterations"] > 0
    assert (stats["pcg_iterations"] > 0) == (solver == "pcg")
    assert (names["call:pose_graph.iteration"] == names["stage:pose_graph.solve"]
            == names["stage:pose_graph.step"] == stats["iterations"])
    assert _leaves_never_nest(events)


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_ba_camera_solve_span_names_its_solver(solver):
    """The camera solve is `stage:ba.cg` on the PCG and `stage:ba.solve` on
    the dense path, one a `call:ba.iteration`, never both in one run."""
    p = ba_problem_from_numpy(_ring_scene(C=8, P=120, seed=2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = tba.bundle_adjust(p, max_iters=6, camera_solver=solver)
    events = _annotations(prof)
    names = Counter(e.name for e in events)
    mine, other = ("stage:ba.cg", "stage:ba.solve")[::1 if solver == "pcg" else -1]
    assert names[mine] == names["call:ba.iteration"] == res.iterations > 0
    assert names[other] == 0
    assert _leaves_never_nest(events)


def _spd_system(n=40, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    A = torch.as_tensor(Q @ Q.T + n * np.eye(n))
    return A, torch.as_tensor(rng.normal(size=n))


@pytest.mark.parametrize("warm", [False, True])
def test_preconditioned_cg_solves_an_spd_system(warm):
    """Jacobi-preconditioned CG on a 40-wide SPD system reaches ‖r‖ ≤
    rtol·‖b‖ within the cap, from zero or from a warm start near the
    answer (which it keeps: its residual is under ‖b‖)."""
    A, b = _spd_system()
    d = torch.diagonal(A)
    exact = torch.linalg.solve(A, b)
    x0 = exact + 1e-3 * torch.ones_like(b) if warm else None
    x, it = tba.preconditioned_cg(lambda v: A @ v, lambda r: r / d, b, 100, 1e-10, x0)
    assert 0 < it <= 40
    assert float(torch.linalg.norm(A @ x - b)) <= 1e-10 * float(torch.linalg.norm(b))


def test_preconditioned_cg_stops_at_its_cap_and_drops_a_bad_warm_start():
    """The cap bounds the iterations; a warm start whose residual is larger
    than ‖b‖ (or non-finite) is replaced by zero, so the first iterate is
    the zero start's."""
    A, b = _spd_system(seed=1)
    d = torch.diagonal(A)

    def run(x0, iters):
        return tba.preconditioned_cg(lambda v: A @ v, lambda r: r / d, b, iters, 1e-14, x0)

    x_zero, it = run(None, 3)
    assert it == 3
    for bad in (1e6 * torch.ones_like(b), torch.full_like(b, float("nan"))):
        x_bad, it_bad = run(bad, 3)
        assert it_bad == 3 and torch.equal(x_bad, x_zero)
