"""The long capture of `chip_smoke.py` (a rendered 540-frame 640×480 sweep,
focal 560, windows matching) through the port's calibrated driver, with
the solvers "auto" picks and with the dense solvers forced, on one
FrontendResult; no trace.

Prints one JSON line per run (ATE, median relative rotation error, the
solver of each BA pass, stage seconds): "auto" cold, dense, "auto" warm.
Then, on the run's rotation graph, the joint rotations + focal multiplier
(from 1.0 in [0.5, 2.0]) by the PCG and the dense solve, on the measured
relative rotations and on the ground truth's for the same edges, and the
measured rotation angle over the true one per edge class (frame gap 1, 2,
3, and the loop-closure edges).

    python3 scripts/long_capture_solvers.py [--frames 540] [--save graph.npz]

Needs an NVIDIA GPU; imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from sphericalsfm_tpu_torch.device import resolve_device  # noqa: E402
from sphericalsfm_tpu_torch.eval.metrics import ate, rotation_error_deg  # noqa: E402
from sphericalsfm_tpu_torch.eval.render import render_capture  # noqa: E402
from sphericalsfm_tpu_torch.geometry.pose import Intrinsics  # noqa: E402
from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log  # noqa: E402
from sphericalsfm_tpu_torch.interop import rotation_graph_from_numpy  # noqa: E402
from sphericalsfm_tpu_torch.optim import ba, pose_graph  # noqa: E402
from sphericalsfm_tpu_torch.pipeline import driver, sfm  # noqa: E402


def accuracy(m, cam_r, cam_t):
    R_gt = np_so3_exp(cam_r)
    R = np_so3_exp(m.cam_r)
    rel = rotation_error_deg(np.einsum("nij,kj->nik", R, R[0]),
                             np.einsum("nij,kj->nik", R_gt, R_gt[0])).numpy()
    return float(ate(m.centers(), -np.einsum("cji,cj->ci", R_gt, cam_t))), float(np.median(rel))


def run(fr, cfg, spec, cam_r, cam_t, name, dense: bool, graph: dict):
    """run_calibrated on `fr`; with `dense`, rotation averaging and every BA
    pass take the dense solve."""
    real_rot, real_prep = driver.optimize_rotations, sfm.prepare_problem

    def rotations(rot0, g, *args, **kw):
        graph.update(rot0=rot0, g=g)
        return real_rot(rot0, g, *args, **(dict(kw, solver="dense") if dense else kw))

    driver.optimize_rotations = rotations
    if dense:
        sfm.prepare_problem = lambda p, solver: real_prep(p, "dense")
    try:
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            m = driver.run_calibrated(None, Intrinsics(spec["focal"], spec["W"] / 2.0,
                                                       spec["H"] / 2.0), out, cfg, frontend=fr,
                                      device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stages = [json.loads(line) for line in open(os.path.join(out, "stages.jsonl"))]
    finally:
        driver.optimize_rotations, sfm.prepare_problem = real_rot, real_prep
    err, rel = accuracy(m, cam_r, cam_t)
    solvers = {k: s[k] for s in stages for k in s if k.endswith("_solver")}
    print(json.dumps(dict(run=name, wall_s=round(wall, 3), ate=err, median_rel_rot_deg=rel,
                          ba_solvers=solvers,
                          stage_s={s["stage"]: s["seconds"] for s in stages})), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=cs.LONG_CAPTURE["F"])
    ap.add_argument("--save", default=None, help="write the rotation graph to this .npz")
    args = ap.parse_args()
    resolve_device("cuda")
    spec = dict(cs.LONG_CAPTURE, F=args.frames)
    F, W, H = spec["F"], spec["W"], spec["H"]
    cam_r, cam_t, gray, color = render_capture(
        num_frames=F, arc=1.0, focal=spec["focal"], width=W, height=H, seed=spec["seed"],
        n_waves=600, wave_freq=25.0 * W / 320.0, device="cuda")
    cfg = cs.eval_suite_config(W)
    cfg.frontend.matching = "windows"
    log = driver.StageLogger(None, verbose=False)
    log.sync = torch.cuda.synchronize
    fr = driver.run_frontend(None, cfg, log, gray, color, device="cuda")
    print(json.dumps(dict(frames=F, frontend_s={r["stage"]: r["seconds"] for r in log.records})),
          flush=True)
    graph = {}
    run(fr, cfg, spec, cam_r, cam_t, "auto_cold", False, graph)
    run(fr, cfg, spec, cam_r, cam_t, "dense", True, {})
    run(fr, cfg, spec, cam_r, cam_t, "auto_warm", False, {})

    g, rot0 = graph["g"], graph["rot0"]
    ei, ej = g.edge_i.cpu().numpy(), g.edge_j.cpu().numpy()
    w, r_meas = g.edge_w.cpu().numpy(), g.r_meas.cpu().numpy()
    R = np_so3_exp(cam_r)
    r_true = np_so3_log(np.einsum("eij,ekj->eik", R[ej], R[ei]))
    out = {}
    for name, rm in (("measured", r_meas), ("ground_truth", r_true)):
        gg = rotation_graph_from_numpy(ei, ej, rm, w, device="cuda")
        out[name] = {s: float(pose_graph.optimize_rotations_and_focal(rot0, gg, 1.0, 0.5, 2.0,
                                                                      solver=s)[1])
                     for s in ("pcg", "dense")}
    gap = ej - ei
    ratio = np.linalg.norm(r_meas, axis=-1) / np.maximum(np.linalg.norm(r_true, axis=-1), 1e-12)
    classes = {"gap1": gap == 1, "gap2": gap == 2, "gap3": gap == 3, "loop": gap > 3}
    angle = {k: dict(live=int((sel & (w > 0)).sum()),
                     median_ratio=float(np.median(ratio[sel & (w > 0)])) if (sel & (w > 0)).any()
                     else None) for k, sel in classes.items()}
    print(json.dumps(dict(focal_mult=out, measured_over_true_angle=angle,
                          live_edges=int((w > 0).sum()), solves=dict(
                              ba=ba.bundle_adjust.solves,
                              rotations=pose_graph.optimize_rotations.solves))), flush=True)
    if args.save:
        np.savez(args.save, edge_i=ei, edge_j=ej, r_meas=r_meas, edge_w=w,
                 rot0=rot0.cpu().numpy(), cam_r_gt=cam_r)


if __name__ == "__main__":
    main()
