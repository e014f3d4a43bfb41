"""What bounds the two-NN kernels: time each with one part taken out.

    python3 scripts/two_nn_ablation.py [--kernel bf16|f32] [--shapes 32x4000]

Writes copies of `sphericalsfm_tpu_torch` under build/ablation/<kernel>_<variant>/
whose kernel source lacks one part, and times each with
scripts/bench_two_nn.py (no correctness check: the ablated kernels compute
wrong answers), each in its own process. For the bf16 kernel
(`csrc/two_nn_wgmma.cu`):
  full       the kernel as committed;
  no_reduce  no top-2 epilogue (the stage is freed at once);
  no_mma     no wgmma (empty commit groups; the epilogue reduces stale sums);
  no_load    no TMA copies of the train tiles (the ring's stages hold stale
             data; the query tile is still loaded);
  mma_only   neither epilogue nor train-tile copies: the tensor cores and
             the ring's barriers alone;
  reduce_only  neither wgmma nor train-tile copies: the epilogue alone.
For the float32 kernel (`csrc/two_nn.cu`; read its `fma_f32_ms`):
  full          the kernel as committed;
  no_top2       the top-2 replaced by one min a distance (the products stay
                live);
  no_train_lds  no_top2, and the train float4s taken from the query
                registers instead of shared memory: the FMAs, the query
                reads and the ring alone.
Needs a GPU; one JSON line per variant and shape.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = {"bf16": "sphericalsfm_tpu_torch/csrc/two_nn_wgmma.cu",
       "f32": "sphericalsfm_tpu_torch/csrc/two_nn.cu"}

NO_REDUCE = [
    ("    reduce_tile(acc, n, sbase, bias, quad, ra, rb);",
     "    fence_acc(acc);\n    mbar_arrive(empty0 + 8 * s);"),
]
NO_MMA = [
    ("    issue_tile(acc, a_base, sbase + kRingOff + s * kTileBytes);",
     "    fence_acc(acc);\n    asm volatile(\"wgmma.commit_group.sync.aligned;\" ::: \"memory\");"),
]
NO_LOAD = [
    ("        mbar_arrive_expect_tx(full, kTileBytes);\n"
     "        tma_load(dst, &desc_map, full, 0, t0, fi);\n"
     "        tma_load(dst + kHalfBytes, &desc_map, full, kHalf, t0, fi);",
     "        mbar_arrive(full + 0 * dst);"),
]
NO_TOP2 = [
    ("      for (int i = 0; i < kMi; ++i) top2(r[i], 2.f - 2.f * acc[i][j] + bias, t);",
     "      for (int i = 0; i < kMi; ++i) r[i].m1 = fminf(r[i].m1, acc[i][j]);"),
]
NO_TRAIN_LDS = [
    ("  float4 tn = lds4(tp);", "  float4 tn = q[0];"),
    ("    if (j + 1 < kMj) tn = lds4(tp + (j + 1) * kIStride);",
     "    if (j + 1 < kMj) tn = q[(j + 1) % kMi];"),
]
VARIANTS = {
    "bf16": {"full": [], "no_reduce": NO_REDUCE, "no_mma": NO_MMA, "no_load": NO_LOAD,
             "mma_only": NO_REDUCE + NO_LOAD, "reduce_only": NO_MMA + NO_LOAD},
    "f32": {"full": [], "no_top2": NO_TOP2, "no_train_lds": NO_TOP2 + NO_TRAIN_LDS},
}


def make_variant(kernel: str, name: str, edits) -> str:
    root = os.path.join(HERE, "build", "ablation", f"{kernel}_{name}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "sphericalsfm_tpu_torch"),
                    os.path.join(root, "sphericalsfm_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, SRC[kernel])
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {SRC[kernel]}: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(VARIANTS), default="bf16")
    ap.add_argument("--shapes", default="32x4000")
    ap.add_argument("--variants", help="comma-separated; all of the kernel's by default")
    args = ap.parse_args()
    variants = VARIANTS[args.kernel]
    rc = 0
    for name in (args.variants.split(",") if args.variants else variants):
        root = make_variant(args.kernel, name, variants[name])
        print(f"== {args.kernel} {name}", flush=True)
        rc |= subprocess.run([sys.executable, os.path.join(HERE, "scripts", "bench_two_nn.py"),
                              "--root", root, "--shapes", args.shapes, "--no-check"]).returncode
    return rc

if __name__ == "__main__":
    sys.exit(main())
