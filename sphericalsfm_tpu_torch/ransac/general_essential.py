"""General (5-point) essential-matrix RANSAC over a batch of pairs — port of
`sphericalsfm_tpu/ransac/general_essential.py`: MSAC over 5-point candidates
(Sampson error), cheirality disambiguation of the best E, then an LM polish
of (r, t) on the inliers, kept when it lowers the MSAC score. Gives the
uncalibrated driver's five-point mode a general relative rotation per pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.so3 import skew, so3_exp, so3_log
from ..optim.lm import levenberg_marquardt
from ..solvers.five_point import cheirality_best, decompose_essential, solve_essential_5pt
from .engine import best_model, msac_score, sample_tuples
from .spherical import _gather_rows, sampson_error


class GeneralRansacResult(NamedTuple):
    E: torch.Tensor            # (B, 3, 3)
    r: torch.Tensor            # (B, 3) relative rotation (axis-angle)
    t: torch.Tensor            # (B, 3) unit translation
    score: torch.Tensor        # (B,)
    inlier_mask: torch.Tensor  # (B, N)
    num_inliers: torch.Tensor  # (B,)


def _essential_of(params):
    t = params[..., 3:]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return skew(t) @ so3_exp(params[..., :3])


def general_essential_ransac(gen: torch.Generator, u: torch.Tensor, v: torch.Tensor,
                             mask: torch.Tensor, sq_thresh: float,
                             num_hypotheses: int = 256, final_least_squares: bool = True,
                             refine_iters: int = 20,
                             solver_method: str = "auto") -> GeneralRansacResult:
    """u, v (B, N, 3) rays, mask (B, N); `num_hypotheses` 5-point samples
    per pair drawn from `gen`; `solver_method` is the 5-point solver's
    eigen method ("auto", "eig" or "qr")."""
    B = u.shape[0]
    samples = sample_tuples(gen, mask, num_hypotheses, 5)                # (B, M, 5)
    Es, valid = solve_essential_5pt(_gather_rows(u, samples), _gather_rows(v, samples),
                                    method=solver_method)
    Es = Es.reshape(B, -1, 3, 3)
    errs = sampson_error(Es, u[:, None], v[:, None])                     # (B, S, N)
    best, score, inliers = best_model(errs, valid.reshape(B, -1), sq_thresh, mask)
    E_best = torch.gather(Es, 1, best[:, None, None, None].expand(-1, 1, 3, 3))[:, 0]

    Rs, ts = decompose_essential(E_best)
    R, t, _ = cheirality_best(Rs, ts, u, v, inliers)
    r = so3_log(R)

    if final_least_squares:
        def residual(params, uu, vv):
            return sampson_error(_essential_of(params), uu, vv)

        x = levenberg_marquardt(residual, torch.cat([r, t], dim=-1), args=(u, v),
                                mask=inliers.to(u.dtype), max_iters=refine_iters,
                                init_lambda=1e-6).x
        r_ref = x[:, :3]
        t_ref = x[:, 3:] / torch.clamp(torch.linalg.norm(x[:, 3:], dim=-1, keepdim=True),
                                       min=1e-12)
        E_ref = _essential_of(x)
        errs_ref = sampson_error(E_ref, u, v)
        score_ref = msac_score(errs_ref, sq_thresh, mask)
        better = score_ref < score
        E_best = torch.where(better[:, None, None], E_ref, E_best)
        score = torch.where(better, score_ref, score)
        inliers = torch.where(better[:, None], (errs_ref < sq_thresh) & mask, inliers)
        r = torch.where(better[:, None], r_ref, r)
        t = torch.where(better[:, None], t_ref, t)

    return GeneralRansacResult(E=E_best, r=r, t=t, score=score, inlier_mask=inliers,
                               num_inliers=inliers.sum(-1))
