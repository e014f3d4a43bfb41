"""Relative-pose accuracy between two COLMAP models — port of
`sphericalsfm_tpu/eval/relpose_eval.py`, the PhoneSweep evaluator: the
images of both models, matched by name, give all-pairs relative rotation
and translation-direction errors; the report has Racc/Tacc@{5,15,30},
AUC@30 of max(rotation, translation) error, all in %, and the relative
focal error.
"""

from __future__ import annotations

import numpy as np

from ..io.colmap import ColmapModel, quat_to_rotmat, read_colmap_model
from .metrics import auc_at


def _poses_by_name(model: ColmapModel) -> dict:
    return {img["name"]: (quat_to_rotmat(img["q"]), img["t"], img["camera_id"])
            for img in model.images.values()}


def relative_pose_errors(pred: ColmapModel, gt: ColmapModel):
    """All-pairs relative rotation / translation angular errors (degrees)
    over the images in both models. Returns (rot_err (M,), trans_err (M,),
    focal_rel_err)."""
    p, g = _poses_by_name(pred), _poses_by_name(gt)
    names = sorted(set(p) & set(g))
    if len(names) < 2:
        raise ValueError(f"only {len(names)} common images")
    iu, ju = np.triu_indices(len(names), k=1)

    def rel(poses):
        R = np.stack([poses[n][0] for n in names])
        t = np.stack([poses[n][1] for n in names])
        Rrel = np.einsum("pij,pkj->pik", R[ju], R[iu])            # R_j R_iᵀ
        return Rrel, t[ju] - np.einsum("pij,pj->pi", Rrel, t[iu])

    Rrp, trp = rel(p)
    Rrg, trg = rel(g)
    cycle = np.einsum("pij,pkj->pik", Rrp, Rrg)
    rot_err = np.degrees(np.arccos(np.clip((np.trace(cycle, axis1=1, axis2=2) - 1) / 2, -1, 1)))

    def norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)

    trans_err = np.degrees(np.arccos(np.clip(np.sum(norm(trp) * norm(trg), axis=-1), -1, 1)))
    f_pred = float(pred.cameras[p[names[0]][2]]["params"][0])
    f_gt = float(gt.cameras[g[names[0]][2]]["params"][0])
    return rot_err, trans_err, abs(f_pred - f_gt) / f_gt


def evaluate_models(pred_dir: str, gt_dir: str) -> dict:
    """The evaluator's report for one sequence (each model binary or text):
    Racc/Tacc@{5,15,30} and AUC@30 in %, focal error in %."""
    rot_err, trans_err, focal_err = relative_pose_errors(read_colmap_model(pred_dir),
                                                         read_colmap_model(gt_dir))
    report = {"num_pairs": int(len(rot_err)), "focal_rel_err_pct": 100 * focal_err}
    for tau in (5, 15, 30):
        report[f"Racc@{tau}"] = 100.0 * float((rot_err < tau).mean())
        report[f"Tacc@{tau}"] = 100.0 * float((trans_err < tau).mean())
    report["AUC@30"] = 100.0 * float(auc_at(np.maximum(rot_err, trans_err), 30.0, 30))
    return report
