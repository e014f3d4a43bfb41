"""What bounds the bf16 two-NN kernel: time it with one part taken out.

    python3 scripts/two_nn_ablation.py [--shapes 32x4000]

Writes copies of `sphericalsfm_tpu_torch` under build/ablation/<variant>/
whose `csrc/two_nn_wgmma.cu` lacks one part, and times each with
scripts/bench_two_nn.py (no correctness check: the ablated kernels compute
wrong answers), each in its own process:
  full       the kernel as committed;
  no_reduce  no top-2 epilogue (the stage is freed at once);
  no_mma     no wgmma (empty commit groups; the epilogue reduces stale sums);
  no_load    no TMA copies of the train tiles (the ring's stages hold stale
             data; the query tile is still loaded);
  mma_only   neither epilogue nor train-tile copies: the tensor cores and
             the ring's barriers alone;
  reduce_only  neither wgmma nor train-tile copies: the epilogue alone.
Needs a GPU; one JSON line per variant and shape.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "sphericalsfm_tpu_torch/csrc/two_nn_wgmma.cu"

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
VARIANTS = {"full": [], "no_reduce": NO_REDUCE, "no_mma": NO_MMA, "no_load": NO_LOAD,
            "mma_only": NO_REDUCE + NO_LOAD, "reduce_only": NO_MMA + NO_LOAD}


def make_variant(name: str, edits) -> str:
    root = os.path.join(HERE, "build", "ablation", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "sphericalsfm_tpu_torch"),
                    os.path.join(root, "sphericalsfm_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, SRC)
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {SRC}: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="32x4000")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    rc = 0
    for name in args.variants.split(","):
        edits = VARIANTS[name]
        root = make_variant(name, edits)
        print(f"== {name}", flush=True)
        rc |= subprocess.run([sys.executable, os.path.join(HERE, "scripts", "bench_two_nn.py"),
                              "--root", root, "--shapes", args.shapes, "--no-check"]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
