"""Run-to-run determinism and time of the detector and rotation averaging
on the card (ROADMAP C26), for this checkout or another one.

    python3 scripts/determinism_check.py [--root DIR] [--reps 3]

Runs `chip_smoke.py`'s determinism phase on the smoke's 48-frame 640×480
capture (focal 512, 1024 keypoints) and two rotation graphs: the capture's
complete 48-node graph (1128 edges, measured rotations = ground truth +
0.2° noise; the dense solver) and a 450-node ring with loop closures (the
PCG). Each is warmed once, then run `reps` times and compared bit for bit;
the phase line gives the seconds of every run. `--root` imports
`sphericalsfm_tpu_torch` from another tree, e.g. the parent commit unpacked
with `git archive` under build/, so two trees can be timed in one call on
one card. Exits 1 if a repeat differs.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("determinism_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    # the package from --root; chip_smoke.py from this checkout
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sphericalsfm_tpu_torch.config import FrontendConfig
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log
    from sphericalsfm_tpu_torch.interop import rotation_graph_from_numpy
    from sphericalsfm_tpu_torch.optim.pose_graph import (
        initialize_rotations_sequential, optimize_rotations,
    )
    from sphericalsfm_tpu_torch.pipeline.frontend import detect_features

    dev = torch.device("cuda")
    F, W, H = 48, 640, 480
    cam_r, _, gray, color = render_capture(num_frames=F, focal=0.8 * W, width=W, height=H,
                                           wave_freq=25.0 * (W / 320), device=dev)
    rng = np.random.default_rng(0)
    R = np_so3_exp(cam_r)
    pi, pj = np.triu_indices(F, 1)
    r_meas = np_so3_log(np.einsum("eij,ekj->eik", R[pj], R[pi]))
    r_meas = r_meas + rng.normal(size=r_meas.shape) * np.deg2rad(0.2) / np.sqrt(3)
    n = 450
    phi = np.arange(n) * 2 * np.pi / n
    ring = [(i, i + 1) for i in range(n - 1)] + [(i, i + n // 2) for i in range(0, n // 2, 45)]
    ri, rj = np.array([a for a, _ in ring]), np.array([b for _, b in ring])
    ring_meas = np.stack([np.zeros(len(ring)), phi[rj] - phi[ri], np.zeros(len(ring))], -1)
    ring_meas = ring_meas + rng.normal(size=ring_meas.shape) * 0.003
    graphs = {}
    for name, (nodes, ei, ej, rm, solver) in {"dense_48": (F, pi, pj, r_meas, "dense"),
                                              "pcg_450": (n, ri, rj, ring_meas, "pcg")}.items():
        g = rotation_graph_from_numpy(ei, ej, rm, np.ones(len(ei)), device=dev)
        graphs[name] = (initialize_rotations_sequential(nodes, g), g, solver)
        optimize_rotations(graphs[name][0], g, solver=solver)   # warm
    cfg = FrontendConfig()
    cfg.max_keypoints = 1024
    detect_features(gray, color, cfg, device=dev)                # warm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), os.path.abspath(args.root),
          flush=True)
    try:
        smoke.run_determinism_phase(gray, color, graphs, device="cuda", reps=args.reps)
    except AssertionError as e:
        print(e, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
