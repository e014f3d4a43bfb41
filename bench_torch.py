"""Round benchmark of the PyTorch + CUDA port: the JAX package's `bench.py`
rows measured by `sphericalsfm_tpu_torch` on one device.

    python3 bench_torch.py                          # every row on the card
    python3 bench_torch.py --compare BENCH_r05.json # each accuracy beside JAX's
    python3 bench_torch.py --only ba,matcher        # some rows
    python3 bench_torch.py --device cpu --quick     # small sizes on the CPU

Each row prints one line as it finishes ({"row": ..., "seconds": ...,
...}); `--compare` then prints one line per accuracy value beside the JAX
row's; the last line is the JSON object of `bench.py`'s keys, plus
`failures` (the rows below their accuracy gates). The exit code is 1 when a
gate failed; a row that raises ends the run with its traceback and a
non-zero exit. No card is an error (`--device cpu` runs the CPU path)."""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# (key of the port's line, the JAX line's value: a key, or (key, pattern))
COMPARE = (
    ("median_rot_err_deg", "median_rot_err_deg"),
    ("static_median_rot_err_deg", "static_median_rot_err_deg"),
    ("ba_cost_at_20", ("ba_workload", r"cost@20it ([0-9.e+-]+)")),
    ("ba_converge_iterations", ("ba_converged", r"^(\d+) iters")),
    ("ba_scale_final_cost", ("ba_scale_workload", r"final cost ([0-9.e+-]+)")),
    ("fivept_qr_median_rot_err_deg", "fivept_qr_median_rot_err_deg"),
    ("sixpt_median_focal_err_pct", "sixpt_median_focal_err_pct"),
    ("matcher_recall_agreement_vs_f32", "matcher_recall_agreement_vs_f32"),
)


def jax_value(parsed: dict, source):
    """The JAX line's value for one COMPARE entry, or None if it has none."""
    if isinstance(source, str):
        return parsed.get(source)
    key, pattern = source
    m = re.search(pattern, str(parsed.get(key, "")))
    return float(m.group(1)) if m else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--only", default=None, help="comma-separated rows to run")
    ap.add_argument("--quick", action="store_true", help="small sizes, for a CPU run")
    ap.add_argument("--compare", default=None, metavar="BENCH_JSON",
                    help="a BENCH_r*.json of the JAX bench: print each accuracy beside it")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from sphericalsfm_tpu_torch.eval import bench

    only = args.only.split(",") if args.only else None

    def log(name, row, seconds):
        print(json.dumps({"row": name, "seconds": round(seconds, 3), **row,
                          "gates": bench.row_gates(name, row)}), flush=True)

    line = bench.run_all(args.device, quick=args.quick, only=only, log=log)
    if args.compare:
        with open(args.compare) as f:
            parsed = json.load(f)["parsed"]
        for key, source in COMPARE:
            if key in line:
                print(json.dumps({"compare": key, "port": line[key],
                                  "jax": jax_value(parsed, source),
                                  "jax_device": parsed.get("device")}), flush=True)
    print(json.dumps(line), flush=True)
    return 1 if line["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
