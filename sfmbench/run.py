"""Run one cell of the benchmark and print its result as the last line.

    python3 sfmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, when no CUDA card is present, when
the cell asks for more cards than there are, or when a module of JAX or of
the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program and its libraries at a fixed path in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "sfmbench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from sfmbench import guard, harness, spec

    cell = spec.cell(args.workload, spec.benchmark(ROOT), ROOT)
    if not cell["limits"]:
        print(f"sfmbench: no limits for {args.workload}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sfmbench: torch.cuda.is_available() is False; this benchmark needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"sfmbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"sfmbench: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    harness.print_checks(result["checks"])
    print(harness.json_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
