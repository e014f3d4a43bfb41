"""Command-line drivers — port of `sphericalsfm_tpu/cli.py`'s verbs:

  python -m sphericalsfm_tpu_torch calibrated   — run_spherical_sfm
  python -m sphericalsfm_tpu_torch uncalibrated — run_spherical_sfm_uncalib
  python -m sphericalsfm_tpu_torch undistort    — undistort_images (needs cv2)
  python -m sphericalsfm_tpu_torch evaluate     — evaluate_sfm_relative
  python -m sphericalsfm_tpu_torch nerf-export  — sphericalsfm2json
  python -m sphericalsfm_tpu_torch panorama     — make_stereo_panorama
  python -m sphericalsfm_tpu_torch circle-views — make_circle_views
  python -m sphericalsfm_tpu_torch solver-bench — synthetic solver sweep

Same flags as the JAX package's verbs; the device verbs (calibrated,
uncalibrated, panorama, circle-views, solver-bench) also take `--device`
(default `cuda`; `cpu` runs the CPU path on request).
"""

from __future__ import annotations

import argparse
import json
import os


def _add_common(p):
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--inward", action="store_true", help="inward-facing capture")
    p.add_argument("--inlierthresh", type=float, default=2.0)
    p.add_argument("--mininliers", type=int, default=100)
    p.add_argument("--minrot", type=float, default=1.0)
    p.add_argument("--stride", type=int, default=1, help="frame stride")
    p.add_argument("--maxkeypoints", type=int, default=4000)
    p.add_argument("--detector", default="tpu", choices=["tpu", "opencv"])
    p.add_argument("--devices", type=int, default=0,
                   help="devices to shard over (0/1 = one device)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--sequential", dest="sequential", action="store_true", default=True,
                   help="adjacent-chain rotation init (reference -sequential)")
    p.add_argument("--global-init", dest="sequential", action="store_false",
                   help="spanning-tree global rotation init")
    p.add_argument("--numbegin", type=int, default=30,
                   help="loop-closure begin window (reference -numbegin)")
    p.add_argument("--numend", type=int, default=30,
                   help="loop-closure end window (reference -numend)")
    p.add_argument("--bestonly", action="store_true",
                   help="keep only the strongest loop closure (reference -bestonly)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="override any config field, e.g. --set focal.strategy=grid "
                        "--set frontend.matching=windows")


def _apply_override(cfg, spec: str):
    path, sep, raw = spec.partition("=")
    if not sep:
        raise SystemExit(f"--set needs SECTION.KEY=VALUE, got {spec!r}")
    obj = cfg
    *parents, leaf = path.split(".")
    for part in parents:
        obj = getattr(obj, part)
    cur = getattr(obj, leaf)  # raises AttributeError on typos
    if isinstance(cur, bool):
        value = raw.lower() in ("1", "true", "yes", "on")
    elif isinstance(cur, int):
        value = int(raw)
    elif isinstance(cur, float):
        value = float(raw)
    else:
        value = raw
    setattr(obj, leaf, value)


def _config_from_args(args):
    from .config import PipelineConfig

    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
    else:
        cfg = PipelineConfig()
    cfg.inward = args.inward
    cfg.ransac.inlier_threshold_px = args.inlierthresh
    cfg.ransac.min_num_inliers = args.mininliers
    cfg.graph.min_rotation_deg = args.minrot
    cfg.graph.sequential = args.sequential
    cfg.graph.num_frames_begin = args.numbegin
    cfg.graph.num_frames_end = args.numend
    cfg.graph.best_only = args.bestonly
    cfg.frontend.frame_stride = args.stride
    cfg.frontend.max_keypoints = args.maxkeypoints
    cfg.frontend.detector = args.detector
    cfg.devices = args.devices
    for spec in args.overrides:
        _apply_override(cfg, spec)
    return cfg


def cmd_calibrated(args):
    from .geometry.pose import Intrinsics
    from .io.nerf import read_calib
    from .pipeline.driver import run_calibrated

    run_calibrated(args.images, Intrinsics(*read_calib(args.intrinsics)), args.output,
                   _config_from_args(args), device=args.device)


def cmd_uncalibrated(args):
    from .pipeline.driver import run_uncalibrated

    cfg = _config_from_args(args)
    cfg.general_ba = args.generalba
    cfg.five_point = args.fivepoint
    cfg.six_point = args.sixpoint
    _, focal = run_uncalibrated(args.images, args.output, cfg, colmap_db=args.colmap,
                                device=args.device)
    print(json.dumps({"focal": focal}))


def cmd_undistort(args):
    """OpenCV 8-coefficient undistortion of video frames to numbered PNGs and
    a pinhole intrinsics file."""
    import cv2
    import numpy as np

    from .io.nerf import read_calib

    os.makedirs(args.output, exist_ok=True)
    coeffs = [float(x) for x in args.distortion.split(",")] if args.distortion else []
    dist = np.zeros(8)
    dist[: len(coeffs)] = coeffs
    focal, cx, cy = read_calib(args.intrinsics)
    K = np.array([[focal, 0, cx], [0, focal, cy], [0, 0, 1]])

    cap = cv2.VideoCapture(args.images)
    i = 0
    newK = None
    size = None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if size is None:
            size = (frame.shape[1], frame.shape[0])
            newK, _ = cv2.getOptimalNewCameraMatrix(K, dist, size, 0)
        und = cv2.undistort(frame, K, dist, None, newK)
        if args.rotate:
            und = cv2.rotate(und, cv2.ROTATE_90_CLOCKWISE)
        cv2.imwrite(os.path.join(args.output, f"{i:06d}.png"), und)
        i += 1
    cap.release()
    f_out = 0.5 * (newK[0, 0] + newK[1, 1])
    with open(os.path.join(args.output, "intrinsics.txt"), "w") as f:
        f.write(f"{f_out} {newK[0, 2]} {newK[1, 2]}\n")
    print(json.dumps({"frames": i, "focal": f_out}))


def cmd_evaluate(args):
    from .eval.relpose_eval import evaluate_models

    print(json.dumps(evaluate_models(args.pred, args.gt), indent=2))


def cmd_nerf_export(args):
    from .io.nerf import export_nerf

    export_nerf(args.poses, args.calib, args.out, args.width, args.height, args.pattern)
    print(json.dumps({"written": args.out}))


def cmd_panorama(args):
    """Stereo panoramas from poses.txt and the source video."""
    from .io.nerf import read_calib
    from .pipeline.frontend import load_frames
    from .pipeline.stereo_panorama import make_stereo_panoramas

    _, color = load_frames(args.images)
    make_stereo_panoramas(args.poses, color, read_calib(args.intrinsics), args.output,
                          pano_width=args.panowidth, nphi=args.nphi, is_loop=not args.noloop,
                          device=args.device)
    print(json.dumps({"output": args.output}))


def cmd_circle_views(args):
    """Synthetic whole views on the synthesis circle."""
    from .io.nerf import read_calib
    from .pipeline.frontend import load_frames
    from .pipeline.stereo_panorama import make_circle_views

    _, color = load_frames(args.images)
    n = make_circle_views(args.poses, color, read_calib(args.intrinsics), args.output,
                          num_views=args.numviews, is_loop=not args.noloop, device=args.device)
    print(json.dumps({"views_written": n}))


def cmd_solver_bench(args):
    """Synthetic 3-point solver accuracy and timing against pixel noise, or
    with `--artifacts DIR` the full CSV and figure set of the solver
    comparisons (eval/experiments.py::solver_artifacts)."""
    import time

    import numpy as np
    import torch

    from .device import resolve_device
    from .eval.metrics import frobenius_error
    from .eval.synthetic import make_random_problems
    from .solvers import solve_spherical_3pt

    dev = resolve_device(args.device)
    if args.artifacts:
        from .eval.experiments import solver_artifacts

        paths = solver_artifacts(args.artifacts, trials=args.trials,
                                 stability_trials=args.trials * 5,
                                 ransac_trials=max(args.trials // 10, 8),
                                 disambiguate=args.disambiguate, device=dev)
        print(json.dumps({"artifacts": paths}, indent=2))
        return

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    for noise in [0.0, 0.5, 1.0, 2.0, 5.0, 10.0]:
        prob = make_random_problems(torch.Generator().manual_seed(int(noise * 10)),
                                    batch=args.trials, num_corr=3, inward=args.inward,
                                    rotation_deg=args.rotation, point_noise=noise / 600.0,
                                    device=dev)
        sync()
        t0 = time.perf_counter()
        Es, valid = solve_spherical_3pt(prob.u, prob.v)
        sync()
        dt = time.perf_counter() - t0
        err = torch.where(valid, frobenius_error(Es, prob.E[:, None]),
                          torch.full_like(valid, float("inf"), dtype=Es.dtype))
        e = torch.min(err, dim=-1).values.cpu().numpy()
        ok = torch.all(prob.valid, dim=-1).cpu().numpy()
        rows.append({
            "noise_px": noise,
            "median_frob": float(np.median(e[ok])),
            "mean_us_per_solve": 1e6 * dt / args.trials,
        })
    print(json.dumps(rows, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sphericalsfm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("calibrated", help="calibrated spherical SfM")
    p.add_argument("--images", required=True, help="video or printf pattern")
    p.add_argument("--intrinsics", required=True, help="text file: focal cx cy")
    _add_common(p)
    p.set_defaults(fn=cmd_calibrated)

    p = sub.add_parser("uncalibrated", help="uncalibrated shared-focal SfM")
    p.add_argument("--images", default=None)
    p.add_argument("--colmap", default=None, help="COLMAP database path")
    p.add_argument("--generalba", action="store_true")
    p.add_argument("--fivepoint", action="store_true",
                   help="use the general 5-pt pairwise estimator")
    p.add_argument("--sixpoint", action="store_true",
                   help="estimate the shared focal by 6-pt joint (E, f) RANSAC on strong "
                        "pairs instead of the focal search sweep")
    _add_common(p)
    p.set_defaults(fn=cmd_uncalibrated)

    p = sub.add_parser("undistort", help="undistort video frames (needs cv2)")
    p.add_argument("--images", required=True)
    p.add_argument("--intrinsics", required=True)
    p.add_argument("--distortion", default="",
                   help="comma-separated distortion coefficients (up to 8)")
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_undistort)

    p = sub.add_parser("evaluate", help="relative-pose accuracy vs GT model")
    p.add_argument("--pred", required=True, help="predicted sparse model dir")
    p.add_argument("--gt", required=True, help="ground-truth sparse model dir")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("nerf-export", help="poses.txt -> transforms.json")
    p.add_argument("--poses", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--width", type=int, required=True)
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--pattern", default="images/%06d.png")
    p.set_defaults(fn=cmd_nerf_export)

    p = sub.add_parser("panorama", help="stereo panorama synthesis")
    p.add_argument("--images", required=True)
    p.add_argument("--poses", required=True, help="poses.txt from a run")
    p.add_argument("--intrinsics", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--panowidth", type=int, default=2048)
    p.add_argument("--nphi", type=int, default=9)
    p.add_argument("--noloop", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_panorama)

    p = sub.add_parser("circle-views", help="synthetic circle views")
    p.add_argument("--images", required=True)
    p.add_argument("--poses", required=True)
    p.add_argument("--intrinsics", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--numviews", type=int, default=64)
    p.add_argument("--noloop", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_circle_views)

    p = sub.add_parser("solver-bench", help="synthetic solver sweep")
    p.add_argument("--trials", type=int, default=1000)
    p.add_argument("--rotation", type=float, default=-1.0)
    p.add_argument("--inward", action="store_true")
    p.add_argument("--artifacts", default=None, metavar="DIR",
                   help="write the full CSV+figure artifact set to DIR (noise curves, "
                        "stability KDE, RANSAC box plots)")
    p.add_argument("--disambiguate", action="store_true",
                   help="score solvers after all-point Sampson disambiguation + cheirality "
                        "decomposition (reference test_random_problems -disambiguate)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_solver_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
