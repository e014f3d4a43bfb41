"""A synthetic reconstruction, written as the program writes its files:
cameras on the rendered circle, points on the textured sphere, noisy
observations, refined to a minimum of the robust cost by the reference's
own Gauss-Newton steps."""

import numpy as np
from scipy.spatial.transform import Rotation

from sfmbench.reference.geometry import so3_exp
from sfmbench.reference.render import camera_truth
from sfmbench.reference.score import gauss_newton


def scene(C=12, P=3000, focal=300.0, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    cam_r, cam_t = camera_truth(C)
    X = rng.normal(size=(P, 3))
    X = 8 * X / np.linalg.norm(X, axis=1, keepdims=True)
    pc = np.einsum("cij,pj->cpi", so3_exp(cam_r), X) + cam_t[:, None]
    vis = ((pc[..., 2] > 0.5) & (np.abs(pc[..., 0] / pc[..., 2]) < 1.0)
           & (np.abs(pc[..., 1] / pc[..., 2]) < 0.8))
    oc, op = np.nonzero(vis)
    uv = focal * pc[oc, op, :2] / pc[oc, op, 2:3] + rng.normal(scale=noise, size=(len(oc), 2))
    keep = (np.bincount(op, minlength=P) >= 3)[op]
    return dict(cam_r=cam_r, cam_t=cam_t, focal=focal, points=X, obs_cam=oc[keep],
                obs_pt=op[keep], obs_uv=uv[keep])


def refine(s, focal_free=False, iters=10):
    """The scene's model moved to a minimum of the robust cost."""
    r, t, X, f = s["cam_r"].copy(), s["cam_t"].copy(), s["points"].copy(), s["focal"]
    for _ in range(iters):
        gn = gauss_newton(r, t, f, focal_free, s["obs_cam"], s["obs_pt"], s["obs_uv"], X)
        X = gn["points"] + gn["d_points"]
        t = t + gn["d_cam"][:, :3]
        r = Rotation.from_matrix(so3_exp(gn["d_cam"][:, 3:]) @ so3_exp(r)).as_rotvec()
        f += gn["d_focal"]
    return dict(s, cam_r=r, cam_t=t, points=X, focal=f)


def write_files(m, width=640, height=480) -> dict:
    """The model as the program's files: poses.txt (15 decimals), the
    COLMAP text model (9 decimals for poses, 6 for points and observations),
    calib.txt."""
    cx, cy = width / 2.0, height / 2.0
    poses = "".join(f"{i} " + " ".join(f"{v:.15f}" for v in (*m["cam_t"][i], *m["cam_r"][i]))
                    + " \n" for i in range(len(m["cam_r"])))
    cams = f"# cameras\n1 SIMPLE_PINHOLE {width} {height} {m['focal']:.6f} {cx:.6f} {cy:.6f}\n"
    images = ["# images"]
    for i in range(len(m["cam_r"])):
        q = Rotation.from_rotvec(m["cam_r"][i]).as_quat()       # x, y, z, w
        t = m["cam_t"][i]
        images.append(f"{i + 1} {q[3]:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} "
                      f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} 1 {i:06d}.png")
        sel = np.nonzero(m["obs_cam"] == i)[0]
        images.append(" ".join(f"{m['obs_uv'][k, 0] + cx:.6f} {m['obs_uv'][k, 1] + cy:.6f} "
                               f"{m['obs_pt'][k] + 1}" for k in sel))
    used = np.unique(m["obs_pt"])
    pts = "# points\n" + "".join(f"{j + 1} {m['points'][j, 0]:.6f} {m['points'][j, 1]:.6f} "
                                 f"{m['points'][j, 2]:.6f} 0 0 0 0\n" for j in used)
    return {"poses.txt": poses, "calib.txt": f"{m['focal']!r} {cx} {cy}\n",
            "sparse/model/cameras.txt": cams, "sparse/model/images.txt": "\n".join(images) + "\n",
            "sparse/model/points3D.txt": pts}
