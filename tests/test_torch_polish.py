"""RANSAC's final rotation polish on the CPU: the plain path's per-pair LM
iterations and accepted flags in both engines' results, the counts that
`estimate_pairwise` makes of them, the dispatch by device (CPU tensors
never reach the kernel; the kernel's wrapper refuses them), the one build
of every CUDA source at the first bind, and the smoke's input generator
and operation count of the polish kernel. The kernel itself is held to the
plain path on the card by tests/test_torch_cuda_polish.py."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from sphericalsfm_tpu_torch.eval.experiments import _contaminate
from sphericalsfm_tpu_torch.eval.synthetic import make_circular_scene, make_random_problems
from sphericalsfm_tpu_torch.geometry.essential import (
    decompose_spherical_essential, make_spherical_essential,
)
from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
from sphericalsfm_tpu_torch.geometry.so3 import so3_exp
from sphericalsfm_tpu_torch.ops import cuda_libs
from sphericalsfm_tpu_torch.pipeline import pairwise as pw
from sphericalsfm_tpu_torch.ransac import spherical as sph
from sphericalsfm_tpu_torch.ransac.engine import msac_score
from sphericalsfm_tpu_torch.ransac.polish_kernel import spherical_polish

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SQ = (2.0 / 600) ** 2


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _problems(B=8, N=128, seed=0, outliers=0.3):
    prob = make_random_problems(torch.Generator().manual_seed(seed), B, N, rotation_deg=5.0,
                                point_noise=1.0 / 600, device="cpu")
    return prob.u, _contaminate(prob, outliers, seed + 1), prob.valid


ENGINES = {
    "static": lambda g, u, v, m, fls: sph.spherical_ransac(g, u, v, m, SQ, num_hypotheses=256,
                                                           final_least_squares=fls),
    "adaptive": lambda g, u, v, m, fls: sph.spherical_ransac_adaptive(
        g, u, v, m, SQ, final_least_squares=fls),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_plain_polish_returns_iterations_and_accepted_flags(engine):
    """Each result carries the LM's iterations of every pair and whether
    its polished model replaced the RANSAC best: the iterations of the LM
    run alone from the unpolished result, and a flag that is set exactly
    where the polished model scores lower. Without the polish, 0 and
    False."""
    u, v, m = _problems()
    run = ENGINES[engine]
    res = run(torch.Generator().manual_seed(3), u, v, m, True)
    raw = run(torch.Generator().manual_seed(3), u, v, m, False)
    assert res.polish_iters.dtype == torch.int64 and res.polish_accepted.dtype == torch.bool
    assert not raw.polish_iters.any() and not raw.polish_accepted.any()
    r0, _ = decompose_spherical_essential(raw.E)
    lm = sph._refine_rotation(r0, u, v, raw.inlier_mask.to(u.dtype), False, 25)
    assert torch.equal(res.polish_iters, lm.iterations)
    assert ((res.polish_iters >= 1) & (res.polish_iters <= 25)).all()
    E_ref = make_spherical_essential(so3_exp(lm.x))
    better = msac_score(sph.sampson_error(E_ref, u, v), SQ, m) < raw.score
    assert torch.equal(res.polish_accepted, better) and better.any()
    assert torch.equal(res.E[better], E_ref[better])
    assert torch.equal(res.E[~better], raw.E[~better])


def test_cpu_tensors_never_reach_the_kernel():
    """The dispatch takes the plain path on CPU tensors, bit for bit, and
    launches nothing; the kernel's wrapper refuses CPU tensors rather
    than fall back."""
    u, v, m = _problems(B=4, N=64, seed=2)
    before = spherical_polish.launches
    raw = sph.spherical_ransac_adaptive(torch.Generator().manual_seed(1), u, v, m, SQ,
                                        final_least_squares=False)
    r0, _ = decompose_spherical_essential(raw.E)
    args = (r0.contiguous(), u, v, m, raw.inlier_mask, raw.E, raw.score, SQ, False, 25)
    got, want = sph._polish(*args), sph._polish_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for engine in ENGINES.values():
        engine(torch.Generator().manual_seed(1), u, v, m, True)
    assert spherical_polish.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        spherical_polish(*args)


def _sweep(F=8, P=600, focal=100.0, size=(320, 240), seed=0):
    """A circular outward capture of F frames: the scene's points projected
    (1 px noise), every pair matched on the points both frames see, 10% of
    each pair's matches replaced by another point."""
    rng = np.random.default_rng(seed)
    poses_r, poses_t, pts = (x.numpy() for x in make_circular_scene(
        torch.Generator().manual_seed(seed), F, P, device="cpu"))
    R = so3_exp(torch.as_tensor(poses_r)).numpy()
    X = np.einsum("fij,pj->fpi", R, pts) + poses_t[:, None]
    w, h = size
    xy = focal * X[..., :2] / X[..., 2:3] + np.array([w / 2, h / 2])
    xy += rng.normal(size=xy.shape)
    seen = (X[..., 2] > 0.5) & (np.abs(xy[..., 0] - w / 2) < w / 2) \
        & (np.abs(xy[..., 1] - h / 2) < h / 2)
    pi, pj = pw.all_pairs(F)
    matches = []
    for i, j in zip(pi, pj):
        idx = np.nonzero(seen[i] & seen[j])[0]
        idx1 = idx.copy()
        bad = rng.uniform(size=len(idx)) < 0.1
        idx1[bad] = rng.integers(0, P, size=int(bad.sum()))
        matches.append((idx, idx1))
    idx0, idx1, mm = pw.pad_match_table(matches, 256)
    return xy, pi, pj, idx0, idx1, mm, Intrinsics(focal, w / 2, h / 2)


@pytest.mark.parametrize("adaptive", [True, False])
def test_estimate_pairwise_counts_the_polish(adaptive, monkeypatch):
    """`counts` carry `polish_iters`, the mean LM iterations a pair, and
    `polish_accept_pct`, the share of pairs whose polished model was kept,
    over every chunk's pairs; read in the gather's one copy."""
    xy, pi, pj, idx0, idx1, mm, intr = _sweep()
    outs = []
    name = "spherical_ransac_adaptive" if adaptive else "spherical_ransac"
    real = getattr(pw, name)

    def recorded(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]

    monkeypatch.setattr(pw, name, recorded)
    res = pw.estimate_pairwise(torch.Generator().manual_seed(0), xy, pi, pj, idx0, idx1, mm,
                               intr, min_num_inliers=20, chunk_size=10, num_hypotheses=256,
                               adaptive=adaptive, device="cpu")
    iters = torch.cat([o.polish_iters for o in outs]).double()
    accepted = torch.cat([o.polish_accepted for o in outs]).double()
    c = res.counts
    assert c["chunks"] == len(outs) == 3
    assert c["polish_iters"] == pytest.approx(float(iters.mean()), rel=1e-12)
    assert c["polish_accept_pct"] == pytest.approx(100.0 * float(accepted.mean()), rel=1e-12)
    assert 1.0 <= c["polish_iters"] <= 25.0 and 0.0 < c["polish_accept_pct"] <= 100.0
    assert ("rounds" in c) == adaptive
    assert res.keep.sum() >= 6        # the neighbours around the circle


def test_first_bind_builds_every_cuda_source_at_once(tmp_path, monkeypatch):
    """The first bind starts one nvcc run per source under csrc/, all
    before waiting on any, and loads every library; later binds only look
    entry points up, and a library already built is not rebuilt."""
    started, waited, loaded = [], [], []

    class Nvcc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.returncode = 0
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            waited.append(len(started))
            return "", ""

    class Library:
        def __init__(self, path):
            loaded.append(os.path.basename(path))

        def __getattr__(self, entry):
            return types.SimpleNamespace(entry=entry)

    monkeypatch.setattr(cuda_libs, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_libs, "_libs", {})
    monkeypatch.setattr(cuda_libs, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_libs.subprocess, "Popen", Nvcc)
    monkeypatch.setattr(cuda_libs.ctypes, "CDLL", Library)
    fn = cuda_libs.bind("spherical_polish.cu", "spherical_polish_f64_launch", [])
    assert fn.entry == "spherical_polish_f64_launch" and fn.restype is cuda_libs.ctypes.c_int
    srcs = cuda_libs.sources()
    assert {"spherical_polish.cu", "two_nn.cu", "two_nn_wgmma.cu"} <= set(srcs)
    assert sorted(os.path.basename(cmd[-1]) for cmd in started) == srcs
    assert waited == [len(srcs)] * len(srcs)          # every run started before the first wait
    assert len(loaded) == len(srcs)
    cuda_libs.bind("two_nn.cu", "two_nn_f32_launch", [])
    assert len(started) == len(srcs) and len(loaded) == len(srcs)
    monkeypatch.setattr(cuda_libs, "_libs", {})
    cuda_libs.bind("two_nn.cu", "two_nn_f32_launch", [])
    assert len(started) == len(srcs) and len(loaded) == 2 * len(srcs)


def test_smoke_polish_inputs_and_operation_count():
    """The inputs the smoke and the card tests give the polish (here on
    the CPU), and the operation count behind the kernel's FP64 bound."""
    smoke = _smoke()
    r0, u, v, mask, inliers, E, score, sq = smoke.polish_inputs(6, 96, device="cpu")
    assert r0.shape == (6, 3) and u.shape == v.shape == (6, 96, 3) and E.shape == (6, 3, 3)
    assert all(t.is_contiguous() for t in (r0, u, v, mask, inliers, E, score))
    assert inliers.any(-1).all() and (inliers.sum(-1) < 0.8 * 96).all()  # 30–70% outliers
    assert sq == SQ
    flops = smoke.polish_flops(torch.tensor([15, 10]), 1024)
    assert flops == 1024 * (42 * (2 + 25) + 213 * 25 + 40 * 2)


@pytest.mark.parametrize("fault", ["score", "kept_model", "inliers", "accepted", "rotation"])
def test_smoke_polish_agreement_catches_a_wrong_polish(fault):
    """The smoke's polish phase holds the kernel to the plain path with
    `polish_agreement`: the plain path against itself passes, and each
    fault of a kernel's epilogue or LM (here applied to the plain path's
    own result on the CPU) fails it."""
    smoke = _smoke()
    args = smoke.polish_inputs(6, 96, device="cpu")
    p = sph._polish_plain(*args, False, 25)
    info, failures = smoke.polish_agreement(args, p, p)
    assert failures == [] and info["kept_both"] > 0 and info["accepted_share"] < 1
    odd = torch.arange(96) % 2 == 1
    bad = {"score": p._replace(score=torch.where(p.accepted, p.score * 1.01, p.score)),
           "kept_model": p._replace(E=torch.where(p.accepted[:, None, None], p.E, 2 * p.E)),
           "inliers": p._replace(inliers=p.inliers & ~odd),
           "accepted": p._replace(accepted=~p.accepted),
           "rotation": p._replace(r=p.r * (1 + 1e-6))}[fault]
    assert smoke.polish_agreement(args, bad, p)[1]


def test_smoke_polish_parts_counts_one_launch_a_part_of_each_chunk():
    """The polish launches the smoke expects of a pairwise sweep: one a
    chunk, or one a shard of each chunk grown with the mesh."""
    smoke = _smoke()
    assert smoke.polish_parts(1128, 128) == 9 and smoke.polish_parts(1770, 128) == 14
    assert smoke.polish_parts(1128, 128, 2) == 18 and smoke.polish_parts(1128, 128, 4) == 36
    assert smoke.polish_parts(3, 128, 4) == 3 and smoke.polish_parts(0, 128) == 0
    assert smoke.polish_parts(100, 64, 16) == 16          # a chunk of 128 on 16 shards
