"""Time the two-NN matcher's kernels on one NVIDIA GPU.

    python3 scripts/bench_two_nn.py [--root DIR] [--shapes 32x1024,32x4000,8x1000:0.05]
                                    [--dump DIR]
    python3 scripts/bench_two_nn.py --compare DIR_A DIR_B

For each shape (pairs x keypoints, optionally `:share` of invalid rows,
2% by default; unit-norm random descriptors made from a seed), checks both
routes against the plain version, then times the bf16 route, the float32
FMA route, the plain version and the library yardstick in bf16 and float32
and prints one JSON line with both routes' bounds; then the card's name and
power limit. The inputs, tolerances, timer and bounds are the matcher's
contract in `sphericalsfm_tpu_torch/eval/kernel_checks.py`, taken from this
checkout.

`--root` times the matcher of `sphericalsfm_tpu_torch` from another
checkout, for example a parent commit unpacked under `build/`, so that two
versions can be timed in one call on one card. A checkout whose wrapper has
one kernel for both dtypes times that kernel on both routes.

`--dump DIR` writes each shape's float32 route outputs to DIR/<shape>.npz
(m1, m2, idx). `--compare DIR_A DIR_B` needs no GPU: it prints, per shape
found in both, whether the two dumps are equal bit for bit, and exits 1 if
any differs or none is shared.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_shape(shape: str):
    """'PxK' or 'PxK:share' → (pairs, K, share of invalid rows)."""
    dims, _, drop = shape.partition(":")
    pairs, K = map(int, dims.split("x"))
    return pairs, K, float(drop) if drop else 0.02


def compare(dir_a: str, dir_b: str) -> int:
    names = sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b)))
    names = [n for n in names if n.endswith(".npz")]
    same_all = bool(names)
    for name in names:
        a, b = np.load(os.path.join(dir_a, name)), np.load(os.path.join(dir_b, name))
        # bit for bit: the float arrays are compared as their 32-bit patterns
        same = {k: bool(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                        and np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)))
                for k in ("m1", "m2", "idx")}
        same_all &= all(same.values())
        print(json.dumps(dict(shape=name[:-4], bit_identical=same)), flush=True)
    print(json.dumps(dict(compared=len(names), all_bit_identical=same_all)), flush=True)
    return 0 if same_all else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--shapes", default="32x1024,32x4000")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the check against the plain version (an ablated kernel)")
    ap.add_argument("--dump", help="write each shape's float32 outputs under this directory")
    ap.add_argument("--compare", nargs=2, metavar=("DIR_A", "DIR_B"),
                    help="compare two --dump directories bit for bit (no GPU)")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("bench_two_nn: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sphericalsfm_tpu_torch.eval import kernel_checks as checks
    root = os.path.abspath(args.root)
    if root != HERE:  # the package again, from the other checkout
        for name in [m for m in sys.modules if m.split(".")[0] == "sphericalsfm_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, root)
    from sphericalsfm_tpu_torch.device import resolve_device
    from sphericalsfm_tpu_torch.ops import matching_kernel as mk

    resolve_device("cuda")
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for seed, shape in enumerate(args.shapes.split(",")):
        pairs, K, drop = parse_shape(shape)
        desc, pi, pj = checks.descriptor_table(seed, pairs, K)
        dev = torch.device("cuda")
        desc32 = torch.as_tensor(desc, device=dev)
        desc = desc32.to(torch.bfloat16)
        valid = torch.as_tensor(np.random.default_rng(seed).uniform(size=desc.shape[:2]) >= drop,
                                device=dev)
        pi, pj = pi.to(dev), pj.to(dev)
        tables = {torch.bfloat16: desc, torch.float32: desc32}
        outs = {dtype: mk.two_nearest_neighbors(table, valid, pi, pj, dtype)
                for dtype, table in tables.items()}
        errs = dict(bf16_max_abs_err=None, f32_max_abs_err=None)
        for dtype in ([] if args.no_check else checks.MATCH_TOL):
            ref = mk.two_nn_reference(tables[dtype], valid, pi, pj, dtype)
            check = checks.plain_check(outs[dtype], ref, valid[pj], dtype)
            if not check["ok"]:
                raise AssertionError(f"kernel != plain version on {shape} {dtype}: {check}")
            key = "bf16_max_abs_err" if dtype == torch.bfloat16 else "f32_max_abs_err"
            errs[key] = check["max_abs_err"]
        if args.dump:
            np.savez(os.path.join(args.dump, f"{shape.replace(':', '_')}.npz"),
                     **{k: x.cpu().numpy() for k, x in zip(("m1", "m2", "idx"),
                                                           outs[torch.float32])})
        del outs
        t = checks.time_kernel(mk.two_nearest_neighbors, mk.two_nn_reference, (desc, valid, pi, pj))
        print(json.dumps(dict(root=os.path.relpath(root, HERE), shape=shape,
                              **errs, **t)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
