"""Time the two-NN matcher's kernels on one NVIDIA GPU.

    python3 scripts/bench_two_nn.py [--root DIR] [--shapes 32x1024,32x4000]

For each shape (pairs x keypoints, unit-norm random descriptors made from a
seed), checks the bf16 route against the plain bf16 version (chip_smoke.py's
tolerances), then times the bf16 route, the float32 FMA route, the plain
version and the library yardstick with chip_smoke.py's timer and prints one
JSON line with the bound; then the card's name and power limit.

`--root` imports `sphericalsfm_tpu_torch` from another checkout, for
example a parent commit unpacked under `build/`, so that two versions can
be timed in one call on one card. A checkout whose wrapper has one kernel
for both dtypes times that kernel on both routes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--shapes", default="32x1024,32x4000")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the check against the plain version (an ablated kernel)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_two_nn: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smoke = load_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from sphericalsfm_tpu_torch.device import resolve_device
    from sphericalsfm_tpu_torch.ops import matching_kernel as mk

    resolve_device("cuda")
    for seed, shape in enumerate(args.shapes.split(",")):
        pairs, K = map(int, shape.split("x"))
        desc, pi, pj = smoke.descriptor_table(seed, pairs, K)
        dev = torch.device("cuda")
        desc = torch.as_tensor(desc, device=dev).to(torch.bfloat16)
        valid = torch.as_tensor(np.random.default_rng(seed).uniform(size=desc.shape[:2]) >= 0.02,
                                device=dev)
        pi, pj = pi.to(dev), pj.to(dev)
        err = None if args.no_check else smoke.compare_two_nn(
            shape, mk.two_nearest_neighbors(desc, valid, pi, pj, torch.bfloat16),
            mk.two_nn_reference(desc, valid, pi, pj, torch.bfloat16), valid[pj], 1e-4, 2e-4)
        t = smoke.time_kernel(mk.two_nearest_neighbors, mk.two_nn_reference, (desc, valid, pi, pj))
        print(json.dumps(dict(root=os.path.relpath(os.path.abspath(args.root), HERE), shape=shape,
                              bf16_max_abs_err=err, **t)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
