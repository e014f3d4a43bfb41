"""Solver and RANSAC experiments — port of
`sphericalsfm_tpu/eval/experiments.py`: noise-response curves, zero-noise
numerical-stability distributions, per-solve timings and full-RANSAC
accuracy sweeps, and the multi-solver comparisons (spherical 3-point,
general 5-point, 7-point, normalized 8-point and, when `cv2` imports,
OpenCV's 5-point), written as CSV artifacts with optional matplotlib
figures (`eval/plots.py`).

Every function runs on `device` (None: CUDA, raising without a card).
Problems are drawn from `torch.Generator().manual_seed(s)` with the JAX
package's seed integers s: the draws are made on the CPU and moved to the
device, so the CPU and the card see the same problems (the JAX stream is
another, ROADMAP C2). CSV columns and rows are the JAX package's.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.essential import (
    decompose_spherical_essential, decompose_spherical_essential_cheirality,
)
from ..geometry.so3 import so3_exp
from ..ransac.spherical import sampson_error, spherical_ransac, spherical_ransac_adaptive
from ..solvers.eight_point import solve_essential_8pt
from ..solvers.five_point import cheirality_best, decompose_essential, solve_essential_5pt
from ..solvers.seven_point import solve_essential_7pt
from ..solvers.spherical import solve_spherical_3pt
from .metrics import frobenius_error, rotation_error_deg, translation_angle_deg
from .synthetic import make_random_problems

FOCAL = 600.0


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def _take(Es, best):
    """Es (B, M, 3, 3), best (B,) -> (B, 3, 3)."""
    return torch.gather(Es, 1, best[:, None, None, None].expand(-1, 1, 3, 3))[:, 0]


def _best_errors(Es, valid, prob):
    """Min-over-candidates Frobenius error, and the rotation and
    translation errors of the best-Frobenius candidate."""
    frob = torch.where(valid, frobenius_error(Es, prob.E[:, None]),
                       torch.tensor(float("inf"), dtype=prob.E.dtype, device=prob.E.device))
    r, t = decompose_spherical_essential(_take(Es, torch.argmin(frob, dim=-1)))
    return (_np(torch.min(frob, dim=-1).values), _np(rotation_error_deg(so3_exp(r), prob.R)),
            _np(translation_angle_deg(t, prob.t)), _np(torch.all(prob.valid, dim=-1)))


def noise_experiment(out_csv: str, noises_px=(0.0, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0),
                     trials: int = 10000, rotation_deg: float = -1.0, inward: bool = False,
                     seed: int = 0, device=None):
    """Median 3-point solver errors against pixel noise."""
    dev = resolve_device(device)
    rows = []
    for i, noise in enumerate(noises_px):
        prob = make_random_problems(_gen(seed + i), batch=trials, num_corr=3, inward=inward,
                                    rotation_deg=rotation_deg, point_noise=noise / FOCAL,
                                    device=dev)
        frob, rot, trans, ok = _best_errors(*solve_spherical_3pt(prob.u, prob.v), prob)
        rows.append({
            "noise_px": noise,
            "median_frob": float(np.median(frob[ok])),
            "median_rot_deg": float(np.median(rot[ok])),
            "median_trans_deg": float(np.median(trans[ok])),
        })
    _write_csv(out_csv, rows)
    return rows


def stability_experiment(out_csv: str, trials: int = 10000, seed: int = 1, device=None):
    """Zero-noise log10 Frobenius error distribution of the 3-point solver."""
    dev = resolve_device(device)
    prob = make_random_problems(_gen(seed), batch=trials, num_corr=3, rotation_deg=-1.0,
                                device=dev)
    frob, _, _, ok = _best_errors(*solve_spherical_3pt(prob.u, prob.v), prob)
    vals = np.log10(np.maximum(frob[ok], 1e-300))
    _write_csv(out_csv, [{"log10_frob": float(v)} for v in vals])
    return {"median": float(np.median(vals)), "q95": float(np.quantile(vals, 0.95))}


def timing_experiment(out_csv: str, batch: int = 4096, reps: int = 20, seed: int = 2,
                      device=None):
    """Mean per-solve latency of the batched 3-point solver (the device is
    synchronized before each clock read)."""
    dev = resolve_device(device)
    prob = make_random_problems(_gen(seed), batch=batch, num_corr=3, rotation_deg=5.0,
                                device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    solve_spherical_3pt(prob.u, prob.v)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        solve_spherical_3pt(prob.u, prob.v)
    sync()
    dt = (time.perf_counter() - t0) / reps
    rows = [{
        "solver": "spherical_3pt_batched",
        "batch": batch,
        "mean_us_per_solve": 1e6 * dt / batch,
        "solves_per_s": batch / dt,
    }]
    _write_csv(out_csv, rows)
    return rows[0]


def _contaminate(prob, outlier_frac: float, seed: int):
    """Second-view rays replaced, with probability `outlier_frac`, by junk
    N(0, 0.5²) image points."""
    if outlier_frac <= 0:
        return prob.v
    g = _gen(seed)
    v = prob.v
    is_out = torch.rand(v.shape[:-1], generator=g, dtype=v.dtype).to(v.device) < outlier_frac
    junk = (torch.randn(v.shape, generator=g, dtype=v.dtype) * 0.5).to(v.device)
    junk[..., 2] = 1.0
    return torch.where(is_out[..., None], junk, v)


def ransac_experiment(out_csv: str, trials: int = 200, num_corr: int = 100,
                      rotation_deg: float = 2.0, noise_px: float = 1.0,
                      outlier_frac: float = 0.0, num_hypotheses: int = 512, seed: int = 3,
                      device=None):
    """Full static-RANSAC accuracy on `trials` problems."""
    dev = resolve_device(device)
    prob = make_random_problems(_gen(seed), batch=trials, num_corr=num_corr,
                                rotation_deg=rotation_deg, point_noise=noise_px / FOCAL,
                                device=dev)
    v = _contaminate(prob, outlier_frac, seed + 1)
    res = spherical_ransac(torch.Generator(device=dev).manual_seed(seed + 2), prob.u, v,
                           prob.valid, (2.0 / FOCAL) ** 2, num_hypotheses=num_hypotheses)
    rot = _np(rotation_error_deg(so3_exp(res.r), prob.R))
    trans = _np(translation_angle_deg(res.t, prob.t))
    rows = [{
        "noise_px": noise_px,
        "outlier_frac": outlier_frac,
        "median_rot_deg": float(np.median(rot)),
        "median_trans_deg": float(np.median(trans)),
        "mean_inliers": float(np.mean(_np(res.num_inliers).astype(np.float64))),
    }]
    _write_csv(out_csv, rows)
    return rows[0]


def _solver_specs():
    """The comparison solver columns: name -> (batched solver over (B, 8, 3)
    correspondences returning candidate Es + valid, spherical?)."""
    def _wrap8(u, v):
        Es, valid = solve_essential_8pt(u, v)
        return Es[:, None], valid[:, None]

    return {
        "spherical_3pt": (lambda u, v: solve_spherical_3pt(u[:, :3], v[:, :3]), True),
        "general_5pt": (lambda u, v: solve_essential_5pt(u[:, :5], v[:, :5]), False),
        "sevenpt": (lambda u, v: solve_essential_7pt(u[:, :7], v[:, :7]), False),
        "normalized_8pt": (_wrap8, False),
    }


def _solve_opencv_5pt(u, v, max_cands: int = 10):
    """Independent cross-check solver: OpenCV's Nistér 5-point
    (cv2.findEssentialMat on the first 5 correspondences of each trial).
    Returns (Es (B, max_cands, 3, 3), valid (B, max_cands)) on u's device
    in the repository's vᵀEu = 0 convention."""
    import cv2

    un, vn = _np(u), _np(v)
    B = un.shape[0]
    Es = np.zeros((B, max_cands, 3, 3))
    valid = np.zeros((B, max_cands), bool)
    K = np.eye(3)
    for b in range(B):
        p1 = (un[b, :5, :2] / un[b, :5, 2:]).astype(np.float64)
        p2 = (vn[b, :5, :2] / vn[b, :5, 2:]).astype(np.float64)
        try:
            E, _ = cv2.findEssentialMat(p1, p2, K, method=cv2.RANSAC, threshold=10.0)
        except cv2.error:
            E = None
        if E is None:
            continue
        cands = E.reshape(-1, 3, 3)[:max_cands]
        Es[b, :len(cands)] = cands
        valid[b, :len(cands)] = True
    return (torch.as_tensor(Es, dtype=u.dtype, device=u.device),
            torch.as_tensor(valid, device=u.device))


def _scored_errors(Es, valid, prob, spherical, inward=False, disambiguate=False):
    """Per-trial (frob, rot_deg, trans_deg, ok) of one solver's candidates.

    `disambiguate=False`: min-over-candidates Frobenius error, rotation and
    translation of the best-Frobenius candidate. `disambiguate=True`: the
    candidate with the lowest total Sampson error over all correspondences,
    decomposed with a cheirality vote over all points; trials with no
    usable candidate are left out of the medians."""
    ok = _np(torch.all(prob.valid, dim=-1))
    if not disambiguate:
        frob, rot, trans, _ = _best_errors(Es, valid, prob)
        return frob, rot, trans, ok

    samp = sampson_error(Es, prob.u[:, None], prob.v[:, None])      # (B, M, N)
    samp = torch.sum(samp * prob.valid[:, None].to(samp.dtype), dim=-1)
    total = torch.where(valid & torch.isfinite(samp), samp, torch.full_like(samp, float("inf")))
    ok = ok & _np(torch.any(torch.isfinite(total), dim=-1))
    E_best = _take(Es, torch.argmin(total, dim=-1))
    frob = _np(frobenius_error(E_best, prob.E))
    if spherical:
        r, t = decompose_spherical_essential_cheirality(E_best, prob.u, prob.v, prob.valid,
                                                        inward=inward)
        R = so3_exp(r)
    else:
        Rs, ts = decompose_essential(E_best)
        R, t, _ = cheirality_best(Rs, ts, prob.u, prob.v, prob.valid)
    return frob, _np(rotation_error_deg(R, prob.R)), _np(translation_angle_deg(t, prob.t)), ok


def relpose_comparison(out_csv: str, angles_deg=(0.5, 1.0, 2.0, 5.0, 10.0),
                       noises_px=(0.0, 1.0, 2.0), trials: int = 1000, seed: int = 5,
                       disambiguate: bool = False, device=None):
    """Every comparison solver's accuracy over an angle × noise grid, as one
    CSV (median Frobenius error per solver; with `disambiguate`, also the
    rotation and translation errors of the single disambiguated solution)."""
    dev = resolve_device(device)
    specs = _solver_specs()
    try:  # OpenCV's 5-point as an independent column, where cv2 imports
        import cv2  # noqa: F401

        specs["opencv_5pt"] = (_solve_opencv_5pt, False)
    except ImportError:
        pass
    rows = []
    for a_i, angle in enumerate(angles_deg):
        for n_i, noise in enumerate(noises_px):
            prob = make_random_problems(_gen(seed + 100 * a_i + n_i), batch=trials, num_corr=8,
                                        rotation_deg=angle, point_noise=noise / FOCAL,
                                        device=dev)
            row = {"rotation_deg": angle, "noise_px": noise}
            for name, (solve, spherical) in specs.items():
                frob, rot, trans, ok = _scored_errors(*solve(prob.u, prob.v), prob, spherical,
                                                      disambiguate=disambiguate)
                row[f"median_frob_{name}"] = float(np.median(frob[ok]))
                if disambiguate:
                    row[f"median_rot_deg_{name}"] = float(np.median(rot[ok]))
                    row[f"median_trans_deg_{name}"] = float(np.median(trans[ok]))
            rows.append(row)
    _write_csv(out_csv, rows)
    return rows


def noise_comparison(out_csv: str, out_plots_dir: str | None = None,
                     noises_px=(0.0, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0), trials: int = 2000,
                     rotation_deg: float = -1.0, inward: bool = False,
                     disambiguate: bool = False, seed: int = 7, device=None):
    """Multi-solver noise sweep: a CSV of per-solver medians and, with
    `out_plots_dir`, the noise curves and per-solver box plots."""
    from .plots import plot_noise_boxes, plot_noise_curves

    dev = resolve_device(device)
    specs = _solver_specs()
    samples = {name: {"frob": [], "rot": [], "trans": []} for name in specs}
    rows = []
    for n_i, noise in enumerate(noises_px):
        prob = make_random_problems(_gen(seed + n_i), batch=trials, num_corr=8,
                                    rotation_deg=rotation_deg, inward=inward,
                                    point_noise=noise / FOCAL, device=dev)
        row = {"noise_px": noise}
        for name, (solve, spherical) in specs.items():
            frob, rot, trans, ok = _scored_errors(*solve(prob.u, prob.v), prob, spherical,
                                                  inward=inward, disambiguate=disambiguate)
            samples[name]["frob"].append(frob[ok])
            samples[name]["rot"].append(rot[ok])
            samples[name]["trans"].append(trans[ok])
            row[f"median_frob_{name}"] = float(np.median(frob[ok]))
            row[f"median_rot_deg_{name}"] = float(np.median(rot[ok]))
            row[f"median_trans_deg_{name}"] = float(np.median(trans[ok]))
        rows.append(row)
    _write_csv(out_csv, rows)
    paths = []
    if out_plots_dir is not None:
        paths += plot_noise_curves(noises_px, samples, out_plots_dir)
        paths += plot_noise_boxes(noises_px, samples, out_plots_dir)
    return rows, paths


def stability_comparison(out_csv: str, out_png: str | None = None, trials: int = 10000,
                         seed: int = 8, device=None):
    """Zero-noise stability of every comparison solver: a CSV of per-solver
    median and 95th-percentile log10 Frobenius error and, with `out_png`,
    the KDE figure."""
    from .plots import plot_stability_kde

    dev = resolve_device(device)
    prob = make_random_problems(_gen(seed), batch=trials, num_corr=8, rotation_deg=-1.0,
                                device=dev)
    log10, rows = {}, []
    for name, (solve, spherical) in _solver_specs().items():
        frob, _, _, ok = _scored_errors(*solve(prob.u, prob.v), prob, spherical)
        vals = np.log10(np.maximum(frob[ok], 1e-300))
        log10[name] = vals
        rows.append({
            "solver": name,
            "median_log10_frob": float(np.median(vals)),
            "q95_log10_frob": float(np.quantile(vals, 0.95)),
        })
    _write_csv(out_csv, rows)
    path = plot_stability_kde(log10, out_png) if out_png else None
    return rows, path


def ransac_comparison(out_csv: str, out_plots_dir: str | None = None, trials: int = 200,
                      num_corr: int = 100, rotation_deg: float = 2.0, noise_px: float = 1.0,
                      outlier_frac: float = 0.25, num_hypotheses: int = 512, seed: int = 9,
                      device=None):
    """Static against adaptive RANSAC on the same contaminated problems: a
    CSV row per engine and, with `out_plots_dir`, the error box plots."""
    from .plots import plot_ransac_boxes

    dev = resolve_device(device)
    prob = make_random_problems(_gen(seed), batch=trials, num_corr=num_corr,
                                rotation_deg=rotation_deg, point_noise=noise_px / FOCAL,
                                device=dev)
    v = _contaminate(prob, outlier_frac, seed + 1)
    sq_thresh = (2.0 / FOCAL) ** 2
    runs = {
        "static": lambda g: spherical_ransac(g, prob.u, v, prob.valid, sq_thresh,
                                             num_hypotheses=num_hypotheses),
        "adaptive": lambda g: spherical_ransac_adaptive(g, prob.u, v, prob.valid, sq_thresh,
                                                        round_size=128,
                                                        max_rounds=num_hypotheses // 128),
    }
    samples, rows = {}, []
    for name, run in runs.items():
        res = run(torch.Generator(device=dev).manual_seed(seed + 2))
        rot = _np(rotation_error_deg(so3_exp(res.r), prob.R))
        trans = _np(translation_angle_deg(res.t, prob.t))
        frob = _np(frobenius_error(res.E, prob.E))
        samples[name] = {"rot": rot, "trans": trans, "frob": frob}
        rows.append({
            "method": name,
            "noise_px": noise_px, "outlier_frac": outlier_frac,
            "median_rot_deg": float(np.median(rot)),
            "median_trans_deg": float(np.median(trans)),
            "median_frob": float(np.median(frob)),
            "mean_inliers": float(np.mean(_np(res.num_inliers).astype(np.float64))),
        })
    _write_csv(out_csv, rows)
    paths = plot_ransac_boxes(samples, out_plots_dir) if out_plots_dir else []
    return rows, paths


def solver_artifacts(out_dir: str, trials: int = 2000, stability_trials: int = 10000,
                     ransac_trials: int = 200, noises_px=(0.0, 1.0, 2.0, 3.0, 5.0, 7.0, 10.0),
                     disambiguate: bool = False, device=None):
    """The full evaluation artifact set (CSVs and PNG figures) in
    `out_dir`: noise comparison with its curves and box plots, stability
    with its KDE, RANSAC with its box plots. Needs matplotlib."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    fig_dir = os.path.join(out_dir, "figures")
    _, p1 = noise_comparison(os.path.join(out_dir, "noise_comparison.csv"), fig_dir,
                             noises_px=noises_px, trials=trials, disambiguate=disambiguate,
                             device=dev)
    _, p2 = stability_comparison(os.path.join(out_dir, "stability.csv"),
                                 os.path.join(fig_dir, "stability_frob.png"),
                                 trials=stability_trials, device=dev)
    _, p3 = ransac_comparison(os.path.join(out_dir, "ransac.csv"), fig_dir,
                              trials=ransac_trials, device=dev)
    return p1 + [p2] + p3


def _write_csv(path: str, rows):
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
