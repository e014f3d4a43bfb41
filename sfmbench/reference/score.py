"""The benchmark's reference scorer: the numbers that decide `correct`.

Plain NumPy and SciPy, float64. It imports nothing of the program and
takes nothing the program made but the files it wrote for one capture,
which are what is judged:

* `poses.txt`: one line a camera, `index t0 t1 t2 r0 r1 r2` (axis-angle,
  world→camera);
* `sparse/model/{images,points3D}.txt`: the COLMAP text model's poses,
  observations and points;
* `calib.txt` (uncalibrated driver): `focal cx cy`.

Against the rendered truth it works out

* `ate`: the RMSE of the camera centres after a similarity (Umeyama)
  alignment onto the truth;
* `rot_med_deg` / `rot_max_deg`: the median and the largest error of the
  relative rotation R_j R_iᵀ over all pairs of cameras;
* `focal_pct`: the focal's error in percent of the true focal;

and from the written model alone

* `missing`: cameras of the capture that the files leave out;
* `file_gap`: the largest gap between a camera's pose in `poses.txt` and
  in the COLMAP model (rotation angle in radians plus translation);
* `ba_gain`: how far the written model lies from a minimum of the robust
  reprojection cost that bundle adjustment minimises (Σ ½·ρ(‖e‖²) with
  Cauchy's ρ, the program's stated loss). The points are re-solved in
  float64 with the cameras held, then one full Gauss-Newton step over the
  cameras (and the focal, where it is free) is predicted on the reduced
  camera system; `ba_gain` is that step's predicted decrease over the cost.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .geometry import centers, quat_to_rotmat, rotation_angle, skew, so3_exp


def parse_poses(text: str):
    """poses.txt → (index (C,), cam_t (C, 3), cam_r (C, 3))."""
    rows = np.array([[float(v) for v in ln.split()] for ln in text.splitlines() if ln.strip()])
    if rows.size == 0:
        return np.zeros(0, np.int64), np.zeros((0, 3)), np.zeros((0, 3))
    return rows[:, 0].astype(np.int64), rows[:, 1:4], rows[:, 4:7]


def parse_colmap(images: str, points: str):
    """The COLMAP text model's poses and observations → dict(q (C, 4),
    t (C, 3), obs_cam (K,), obs_pt (K,), obs_xy (K, 2), xyz (P, 3)).
    Observations keep only those of written points."""
    lines = [ln for ln in images.splitlines() if not ln.startswith("#")]
    qs, ts, oc, op, oxy = [], [], [], [], []
    for c, k in enumerate(range(0, len(lines) - 1, 2)):
        head = lines[k].split()
        qs.append([float(v) for v in head[1:5]])
        ts.append([float(v) for v in head[5:8]])
        vals = lines[k + 1].split()
        if vals:
            a = np.asarray(vals, np.float64).reshape(-1, 3)
            oc.append(np.full(len(a), c, np.int64))
            op.append(a[:, 2].astype(np.int64))
            oxy.append(a[:, :2])
    pts = np.array([[float(v) for v in ln.split()[:4]] for ln in points.splitlines()
                    if ln.strip() and not ln.startswith("#")]).reshape(-1, 4)
    point_ids = pts[:, 0].astype(np.int64)
    obs_cam = np.concatenate(oc) if oc else np.zeros(0, np.int64)
    obs_id = np.concatenate(op) if op else np.zeros(0, np.int64)
    obs_xy = np.concatenate(oxy) if oxy else np.zeros((0, 2))
    order = np.argsort(point_ids)
    pos = np.clip(np.searchsorted(point_ids[order], obs_id), 0, max(len(point_ids) - 1, 0))
    known = (point_ids[order][pos] == obs_id) if len(point_ids) else np.zeros(len(obs_id), bool)
    return dict(q=np.asarray(qs).reshape(-1, 4), t=np.asarray(ts).reshape(-1, 3),
                obs_cam=obs_cam[known], obs_pt=order[pos[known]], obs_xy=obs_xy[known],
                xyz=pts[:, 1:4])


def ate(est_centers, true_centers) -> float:
    """RMSE of camera centres after the similarity (Umeyama) alignment of
    the estimate onto the truth."""
    ce, cg = np.asarray(est_centers, np.float64), np.asarray(true_centers, np.float64)
    mu_e, mu_g = ce.mean(0), cg.mean(0)
    xe, xg = ce - mu_e, cg - mu_g
    U, S, Vt = np.linalg.svd(xe.T @ xg / len(ce))
    D = np.array([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    rot = (U @ np.diag(D) @ Vt).T
    var_e = np.mean(np.sum(xe * xe, -1))
    scale = np.sum(S * D) / (var_e if var_e > 1e-18 else 1.0)
    aligned = scale * xe @ rot.T + mu_g
    return float(np.sqrt(np.mean(np.sum((aligned - cg) ** 2, -1))))


def relative_rotation_errors_deg(R_est, R_true) -> np.ndarray:
    """Angle between R_j R_iᵀ of the estimate and of the truth, all i < j."""
    iu, ju = np.triu_indices(len(R_est), k=1)
    rel_e = np.einsum("pij,pkj->pik", R_est[ju], R_est[iu])
    rel_t = np.einsum("pij,pkj->pik", R_true[ju], R_true[iu])
    return np.degrees(rotation_angle(np.einsum("pij,pkj->pik", rel_e, rel_t)))


def _sum_at(index, values, n: int) -> np.ndarray:
    """Σ of `values` at each flat `index`, as an (n,) array."""
    return np.bincount(np.ravel(index), weights=np.ravel(values), minlength=n)


def _point_system(obs_pt, P, w, Jx, e):
    """Each point's Gauss-Newton matrix (P, 3, 3) and gradient (P, 3)."""
    k9 = 9 * obs_pt[:, None] + np.arange(9)
    k3 = 3 * obs_pt[:, None] + np.arange(3)
    Hp = _sum_at(k9, w[:, None] * np.einsum("kai,kaj->kij", Jx, Jx).reshape(-1, 9), 9 * P)
    gp = _sum_at(k3, w[:, None] * np.einsum("kai,ka->ki", Jx, e), 3 * P)
    return Hp.reshape(P, 3, 3), gp.reshape(P, 3)


def _solvable(Hp) -> np.ndarray:
    """Points whose 3×3 system is well posed (seen from two directions)."""
    ev = np.linalg.eigvalsh(Hp)
    return ev[:, 0] > 1e-12 * np.maximum(ev[:, 2], 1e-300)


def _cauchy(s, c2):
    return c2 * np.log1p(s / c2), 1.0 / (1.0 + s / c2)


def _project(R, t, X, focal, uv):
    """Residuals e (K, 2), camera-frame points pc (K, 3) and de/dpc (K, 2, 3)."""
    pc = np.einsum("kij,kj->ki", R, X) + t
    z = np.where(np.abs(pc[:, 2]) > 1e-12, pc[:, 2], 1e-12)
    q = pc[:, :2] / z[:, None]
    e = focal * q - uv
    dpc = np.zeros((len(pc), 2, 3))
    dpc[:, 0, 0] = dpc[:, 1, 1] = focal / z
    dpc[:, :, 2] = -focal * q / z[:, None]
    return e, q, dpc


def gauss_newton(cam_r, cam_t, focal: float, focal_free: bool, obs_cam, obs_pt, obs_uv,
                 points, loss_scale: float = 1.0, fixed_camera: int = 0,
                 point_iters: int = 5) -> dict:
    """One Gauss-Newton step from a model: the points re-solved with the
    cameras held, then the step over the cameras (and the focal, where it
    is free) on the reduced camera system, whose one null direction (the
    scale of the scene) is left out. `obs_uv` is centred at the principal
    point; camera `fixed_camera` is held, as the program holds it. Returns
    {cost, decrease (the step's predicted decrease), points (re-solved),
    d_cam (C, 6): translation then left rotation, d_focal, d_points}."""
    c2 = loss_scale * loss_scale
    R_all = so3_exp(cam_r)
    X = np.array(points, np.float64)
    P, C, K = len(X), len(cam_r), len(obs_cam)
    R, t = R_all[obs_cam], np.asarray(cam_t, np.float64)[obs_cam]
    for _ in range(point_iters):                       # points, cameras held
        e, _, dpc = _project(R, t, X[obs_pt], focal, obs_uv)
        _, w = _cauchy(np.sum(e * e, -1), c2)
        Hp, gp = _point_system(obs_pt, P, w, dpc @ R, e)
        ok = _solvable(Hp)
        X[ok] -= np.linalg.solve(Hp[ok], gp[ok][..., None])[..., 0]
    e, q, dpc = _project(R, t, X[obs_pt], focal, obs_uv)
    rho, w = _cauchy(np.sum(e * e, -1), c2)
    cost = 0.5 * float(np.sum(rho))
    RX = np.einsum("kij,kj->ki", R, X[obs_pt])
    Jc = np.concatenate([dpc, dpc @ -skew(RX)], -1)    # (K, 2, 6): t, then left rotation
    Jx = dpc @ R
    free = np.arange(C) != fixed_camera
    col = np.cumsum(free) - 1                          # camera → its block among the free
    nf = int(free.sum())
    n_cam = 6 * nf + (1 if focal_free else 0)
    live = free[obs_cam]
    # camera columns of each observation: 6 per free camera, then the focal
    Jcam = np.zeros((K, 2, 7))
    Jcam[:, :, :6] = Jc * live[:, None, None]
    Jcam[:, :, 6] = q if focal_free else 0.0
    cols = np.concatenate([6 * np.where(live, col[obs_cam], 0)[:, None] + np.arange(6),
                           np.full((K, 1), n_cam - 1 if focal_free else 0)], 1)
    wJ = w[:, None, None] * Jcam
    Hcc = _sum_at(cols[:, :, None] * n_cam + cols[:, None, :],
                  np.einsum("kai,kaj->kij", wJ, Jcam), n_cam * n_cam).reshape(n_cam, n_cam)
    gc = _sum_at(cols, np.einsum("kai,ka->ki", wJ, e), n_cam)
    Hp, gp = _point_system(obs_pt, P, w, Jx, e)
    # Hcp: one 7×3 block per observation at (its camera columns, its point)
    Hcp_blocks = np.einsum("kai,kaj->kij", wJ, Jx)
    rows = np.broadcast_to(cols[:, :, None], (K, 7, 3)).reshape(-1)
    pcol = (3 * obs_pt[:, None, None] + np.arange(3)[None, None, :])
    pcol = np.broadcast_to(pcol, (K, 7, 3)).reshape(-1)
    Hcp = sp.csr_matrix((Hcp_blocks.reshape(-1), (rows, pcol)), shape=(n_cam, 3 * P))
    ok = _solvable(Hp)
    Hp_inv = np.zeros_like(Hp)
    Hp_inv[ok] = np.linalg.inv(Hp[ok])
    Hpp_inv = sp.block_diag(list(Hp_inv), format="csr") if P else sp.csr_matrix((0, 0))
    M = Hcp @ Hpp_inv
    S = Hcc - (M @ Hcp.T).toarray()
    b = gc - M @ gp.reshape(-1)
    lam, U = np.linalg.eigh(0.5 * (S + S.T))
    keep = lam > 1e-10 * lam.max()
    proj = U[:, keep].T @ b
    step = -U[:, keep] @ (proj / lam[keep])
    d_cam = np.zeros((C, 6))
    d_cam[free] = step[:6 * nf].reshape(nf, 6)
    d_points = -(Hpp_inv @ (gp.reshape(-1) + Hcp.T @ step)).reshape(P, 3)
    return dict(cost=cost, decrease=0.5 * float(np.sum(proj * proj / lam[keep])), points=X,
                d_cam=d_cam, d_focal=float(step[-1]) if focal_free else 0.0, d_points=d_points)


def ba_gain(*args, **kwargs) -> float:
    """`gauss_newton`'s predicted decrease over the cost: 0 at a minimum
    of the robust reprojection cost."""
    gn = gauss_newton(*args, **kwargs)
    return gn["decrease"] / max(gn["cost"], 1e-300)


def score_capture(files: dict, truth: dict) -> dict:
    """The numbers of one capture. `files` maps each written file's path
    under the capture's output directory to its text; `truth` holds the
    rendered cam_r, cam_t, focal, width, height, and whether the focal is
    estimated (`focal_free`)."""
    F = len(truth["cam_r"])
    idx, cam_t, cam_r = parse_poses(files.get("poses.txt", ""))
    model = parse_colmap(files["sparse/model/images.txt"], files["sparse/model/points3D.txt"])
    have = np.zeros(F, bool)
    have[idx[(idx >= 0) & (idx < F)]] = True
    missing = int(F - have.sum()) + int(abs(len(model["q"]) - F))
    out = dict(missing=missing)
    if missing:
        return out
    order = np.argsort(idx)
    cam_t, cam_r = cam_t[order], cam_r[order]
    R_est, R_true = so3_exp(cam_r), so3_exp(truth["cam_r"])
    R_col = quat_to_rotmat(model["q"])
    out["file_gap"] = float(np.max(rotation_angle(np.einsum("cij,ckj->cik", R_est, R_col))
                                   + np.max(np.abs(cam_t - model["t"]), -1)))
    out["ate"] = ate(centers(cam_r, cam_t), centers(truth["cam_r"], truth["cam_t"]))
    rot = relative_rotation_errors_deg(R_est, R_true)
    out["rot_med_deg"] = float(np.median(rot))
    out["rot_max_deg"] = float(np.max(rot))
    if truth["focal_free"]:
        focal = float(files["calib.txt"].split()[0])
        out["focal_pct"] = 100.0 * abs(focal - truth["focal"]) / truth["focal"]
    else:
        focal = float(truth["focal"])
    uv = model["obs_xy"] - np.array([truth["width"] / 2.0, truth["height"] / 2.0])
    out["ba_gain"] = ba_gain(cam_r, cam_t, focal, truth["focal_free"], model["obs_cam"],
                             model["obs_pt"], uv, model["xyz"])
    return out
