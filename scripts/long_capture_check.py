"""Readings of the benchmark's `correct` numbers (`sfmbench/control.py`)
for a configuration under a traffic mix, with, for every sound capture, its
counts and its rotation averaging held against the plain reference.

    python3 scripts/long_capture_check.py \\
        --config sfmbench/configs/calibrated_windows_sweep.json --traffic circle_vga_f512 \\
        --variant sound --seeds 1,2,3 [--variant ba_early --seeds 4,5 ...] \\
        [--out readings.jsonl]

The configuration and the traffic need no cell in BENCHMARK.json.

For each sound capture it prints one JSON line `rotations`: the windows
pairs, the rotation LM's solver, LM and CG iterations, and each BA pass's
solver and iterations from `stages.jsonl`; and the capture's own rotation
graph (the one the driver handed to `optimize_rotations`) minimised again by
`sfmbench/reference/rotations.py` in float64 and in float32 on the same
device, from the same start, beside the port's PCG rotations and cost.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sfmbench import capture, control, spec  # noqa: E402
from sfmbench.reference import rotations as ref  # noqa: E402
from sfmbench.reference.geometry import rotation_angle, so3_exp  # noqa: E402

# the port's PCG against the reference's dense LM (tests/test_torch_long_capture.py)
COST_RTOL = 1e-11
ANGLE_DEG = 1e-5


def _max_angle_deg(a, b) -> float:
    Ra, Rb = so3_exp(a.double().cpu().numpy()), so3_exp(b.double().cpu().numpy())
    return float(np.degrees(rotation_angle(np.einsum("nij,nkj->nik", Ra, Rb))).max())


def compare(graph: dict) -> dict:
    """The reference in float64 and float32 on the graph, against the
    port's rotations and cost."""
    g, rot0 = graph["g"], graph["rot0"]
    out = dict(nodes=int(rot0.shape[0]), live_edges=int((g.edge_w > 0).sum()),
               port_cost=float(graph["cost"]))
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        t0 = time.perf_counter()
        r = ref.optimize_rotations(rot0.to(dt), g.edge_i, g.edge_j, g.r_meas.to(dt),
                                   g.edge_w.to(dt))
        cost = float(ref.cost(r["rotations"].double(), g.edge_i, g.edge_j, g.r_meas, g.edge_w))
        out[name] = dict(seconds=time.perf_counter() - t0, iterations=r["iterations"],
                         cost=cost, initial_cost=float(r["initial_cost"]),
                         cost_rel=abs(cost - out["port_cost"]) / max(cost, 1e-300),
                         max_angle_deg=_max_angle_deg(r["rotations"], graph["rots"]))
    f64 = out["float64"]
    out["within"] = f64["cost_rel"] <= COST_RTOL and f64["max_angle_deg"] <= ANGLE_DEG
    f32 = out["float32"]
    out["float32_fails"] = f32["cost_rel"] > COST_RTOL or f32["max_angle_deg"] > ANGLE_DEG
    return out


def counts(stages: list) -> dict:
    """The windows pairs, the rotation LM's and each BA pass's solver and
    iterations, from one capture's stage records."""
    out = {}
    for s in stages:
        if s["stage"] == "match_pairs":
            out.update(pairs=s.get("pairs"), mode=s.get("mode"))
        elif s["stage"] == "rotation_init":
            out["rotation"] = {k: s.get(k) for k in ("solver", "iterations", "pcg_iterations")}
        for k in range(1, 5):
            if f"ba{k}_solver" in s:
                out[f"ba{k}"] = {key: s.get(f"ba{k}_{key}")
                                 for key in ("solver", "iterations", "pcg_iterations")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="a configuration file")
    ap.add_argument("--traffic", required=True, help="a traffic mix of sfmbench/traffic/")
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--seeds", action="append", required=True)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plan = [(v, [int(s) for s in ss.split(",")]) for v, ss in zip(args.variant, args.seeds)]
    config = spec.load_json(args.config)
    traffic = spec.load_json(os.path.join(ROOT, "sfmbench", "traffic", f"{args.traffic}.json"))
    cell = dict(name=f"{config['name']}.{args.traffic}", config=config, traffic=traffic)

    from sphericalsfm_tpu_torch.pipeline import driver

    graphs, records = [], []
    real_opt, real_run = driver.optimize_rotations, capture.run_capture

    def optimize_rotations(rot0, g, *a, **kw):
        out = real_opt(rot0, g, *a, **kw)
        graphs.append(dict(rot0=rot0, g=g, rots=out[0], cost=out[1]))
        return out

    def run_capture(*a, **kw):
        rec = real_run(*a, **kw)
        records.append(rec["stages"])
        return rec

    def log(line, flush=True):
        print(line, flush=flush)
        row = json.loads(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if row["variant"] == "sound" and graphs and records:
            extra = dict(workload=row["workload"], seed=row["seed"], **counts(records[-1]),
                         rotations=compare(graphs[-1]))
            print(json.dumps(extra), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(extra) + "\n")
        graphs.clear()
        records.clear()

    driver.optimize_rotations, capture.run_capture = optimize_rotations, run_capture
    t0 = time.perf_counter()
    try:
        control.readings(cell, plan, args.device, log=log)
    finally:
        driver.optimize_rotations, capture.run_capture = real_opt, real_run
    print(json.dumps(dict(workload=cell["name"], seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
