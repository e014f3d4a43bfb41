"""Readings of the numbers that decide `correct`, for the program as it is
and with a control or a fault installed, at a cell's own size.

    python3 sfmbench/control.py --workload <cell> --variant sound --seeds 1,2,3 \\
        [--variant float32 --seeds 4,5,6 ...] [--out readings.jsonl]

One process: the program and its kernels are loaded once and one cold
capture runs first; then, for each variant and each of its seeds, the
first capture of that seed's pool runs through the variant and its written
model is scored. Each reading is one JSON line. The limits in
`limits/<cell>.json` are set from these readings: the lower from sound
runs over a dozen seeds or more, the upper from the controls and faults.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sfmbench import capture, guard, harness, spec, traffic  # noqa: E402
from sfmbench.variants import variant  # noqa: E402


def readings(cell: dict, plan: list, device: str = "cuda", log=print) -> list:
    """[(variant, seed, wall, numbers)] for each (variant, seeds) of `plan`."""
    from sphericalsfm_tpu_torch.device import resolve_device

    resolve_device(device)
    harness._load_kernels(device)
    config, traf = cell["config"], cell["traffic"]
    one = dict(traf, pool=1)
    out, warm = [], False
    for name, seeds in plan:
        for seed in seeds:
            item = traffic.make_pool(one, config["frames"], seed, device)[0]
            cfg = capture.pipeline_config(config)
            if not warm:                       # the process's cold capture
                capture.run_capture(config, item, cfg, device)
                warm = True
            with variant(name, cfg):
                try:
                    rec = capture.run_capture(config, item, cfg, device)
                except Exception as e:         # a variant that crashes has failed
                    numbers, wall = {"error": repr(e)}, None
                else:
                    numbers, wall = harness.score_one(rec, item, config), rec["wall"]
            out.append((name, seed, wall, numbers))
            log(json.dumps(dict(workload=cell["name"], variant=name, seed=seed, wall=wall,
                                **numbers), default=float), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--seeds", action="append", required=True,
                    help="comma-separated seeds, one list per --variant")
    ap.add_argument("--out", help="append the readings to this JSONL file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.variant) != len(args.seeds):
        ap.error("give one --seeds per --variant")
    plan = [(v, [int(s) for s in ss.split(",")]) for v, ss in zip(args.variant, args.seeds)]
    cell = spec.cell(args.workload, spec.benchmark(ROOT), ROOT)
    t0 = time.perf_counter()
    rows = readings(cell, plan, args.device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for name, seed, wall, numbers in rows:
                f.write(json.dumps(dict(workload=cell["name"], variant=name, seed=seed,
                                        wall=wall, **numbers), default=float) + "\n")
    print(json.dumps(dict(workload=cell["name"], seconds=time.perf_counter() - t0,
                          forbidden=guard.forbidden_modules())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
