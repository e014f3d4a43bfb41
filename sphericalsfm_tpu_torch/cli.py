"""Command-line drivers — port of `sphericalsfm_tpu/cli.py`'s driver verbs:

  python -m sphericalsfm_tpu_torch calibrated   — run_spherical_sfm
  python -m sphericalsfm_tpu_torch uncalibrated — run_spherical_sfm_uncalib

Same flags as the JAX package's verbs, plus `--device` (default `cuda`;
`cpu` runs the CPU path on request).
"""

from __future__ import annotations

import argparse
import json


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
    from .pipeline.driver import run_calibrated

    with open(args.intrinsics) as f:
        focal, cx, cy = (float(x) for x in f.read().split()[:3])
    run_calibrated(args.images, Intrinsics(focal, cx, cy), args.output,
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

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
