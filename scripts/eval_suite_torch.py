"""The hard evaluation suite through the PyTorch port, beside the JAX table.

Runs the 14 rendered sequences of `sphericalsfm_tpu_torch.eval.suite` (or
the 4 quick ones) through the port's uncalibrated driver, one report per
sequence in OUT_DIR/<name>/report.json, and the summary in
OUT_DIR/suite.json. A full, unfiltered run also writes
EVAL_SUITE_TORCH.md and eval_suite_torch_results.json at the repo root,
headed by the card's name and power limit, each row beside the JAX row of
eval_suite_results.json.

Usage:
  python scripts/eval_suite_torch.py OUT_DIR                      # 14 sequences, CUDA
  python scripts/eval_suite_torch.py OUT_DIR --compare            # ... gated against JAX
  python scripts/eval_suite_torch.py OUT_DIR --quick --device cpu # 4 small ones, CPU
  python scripts/eval_suite_torch.py OUT_DIR --only NAME [NAME ...] [--resume]

--resume reuses a sequence's saved report unless it holds an `error`.
A sequence that raises prints its traceback and is scored as a penalty row
with an `error` key. --compare [PATH] prints every row beside the JAX row
of PATH (default: the repo's eval_suite_results.json) and exits 1 if a
gated row misses:
  * every row: no `error`;
  * every row but the two lowtex_*: AUC@30 >= JAX - 1.0, focal error
    <= max(1.0, JAX + 0.5) %, ATE < 0.05;
  * over all 14 rows: mean AUC@30 >= JAX mean - 1.0.
A lowtex row whose AUC@30 falls more than 10 below JAX's is flagged.
The script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sphericalsfm_tpu_torch.eval import suite  # noqa: E402

REFERENCE = os.path.join(ROOT, "eval_suite_results.json")
UNGATED = ("lowtex_f560_120", "lowtex_f800_100")  # reported, not gated
AUC_SLACK, FOCAL_SLACK, FOCAL_FLOOR, ATE_MAX = 1.0, 0.5, 1.0, 0.05
LOWTEX_FLAG = 10.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir", nargs="?", default="build/eval_suite_torch")
    p.add_argument("--quick", action="store_true", help="the 4 small sequences")
    p.add_argument("--only", nargs="+", metavar="NAME", help="run only these sequences")
    p.add_argument("--resume", action="store_true",
                   help="reuse saved reports that hold no error")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--compare", nargs="?", const=REFERENCE, default=None, metavar="PATH",
                   help="gate every row against the JAX table (default %(const)s)")
    return p.parse_args(argv)


def penalty_report(spec: dict, err: BaseException) -> dict:
    """The JAX script's worst-case row for a sequence that raised."""
    rep = dict.fromkeys(suite.METRICS, 0.0)
    rep.update(sequence=spec["name"], frames=spec["frames"],
               outlier_frac=spec.get("outliers", 0.0), inward=spec.get("inward", False),
               focal_true=spec["focal"], focal_est=0.0, focal_rel_err_pct=100.0, ate=1.0,
               wall_s=0.0, error=repr(err))
    return rep


def run_suite(specs, out_root: str, resume: bool = False, device=None) -> list:
    reports = []
    for spec in specs:
        rep_path = os.path.join(out_root, spec["name"], "report.json")
        rep = None
        if resume and os.path.exists(rep_path):
            with open(rep_path) as f:
                rep = json.load(f)
            if "error" in rep:
                print(f"re-running {spec['name']}: its saved report holds an error", flush=True)
                rep = None
        if rep is None:
            try:
                rep = suite.run_sequence(spec, out_root, device=device)
            except Exception as e:  # keep the suite alive; score the failure
                traceback.print_exc()
                print(f"SEQUENCE FAILED {spec['name']}: {e!r}", flush=True)
                rep = penalty_report(spec, e)
            os.makedirs(os.path.dirname(rep_path), exist_ok=True)
            with open(rep_path, "w") as f:
                json.dump(rep, f, indent=2)
        print(json.dumps(rep), flush=True)
        reports.append(rep)
    return reports


def load_reference(path: str) -> dict:
    with open(path) as f:
        ref = json.load(f)
    return {"rows": {r["sequence"]: r for r in ref["per_sequence"]},
            "aggregate": ref["aggregate"]}


def row_misses(rep: dict, ref: dict | None) -> list:
    """Why a row misses its gate against its JAX row (empty: it passes)."""
    if "error" in rep:
        return [f"raised {rep['error']}"]
    if ref is None or rep["sequence"] in UNGATED:
        return []
    misses = []
    if not rep["AUC@30"] >= ref["AUC@30"] - AUC_SLACK:
        misses.append(f"AUC@30 {rep['AUC@30']:.4f} < {ref['AUC@30'] - AUC_SLACK:.4f}")
    focal_max = max(FOCAL_FLOOR, ref["focal_rel_err_pct"] + FOCAL_SLACK)
    if not rep["focal_rel_err_pct"] <= focal_max:
        misses.append(f"focal error {rep['focal_rel_err_pct']:.4f}% > {focal_max:.4f}%")
    if not rep["ate"] < ATE_MAX:
        misses.append(f"ATE {rep['ate']:.4f} >= {ATE_MAX}")
    return misses


def compare(reports: list, reference: dict) -> tuple:
    """(lines, ok): every row beside its JAX row with its verdict, then the
    mean AUC@30 gate when the run covers every JAX sequence."""
    lines, ok = [], True
    for rep in reports:
        ref = reference["rows"].get(rep["sequence"])
        misses = row_misses(rep, ref)
        ok &= not misses
        if ref is None:
            jax_cols = "no JAX row"
        else:
            jax_cols = (f"JAX AUC {ref['AUC@30']:.3f} focal {ref['focal_rel_err_pct']:.3f}% "
                        f"ATE {ref['ate']:.4f}")
        verdict = "MISS: " + "; ".join(misses) if misses else (
            "reported" if rep["sequence"] in UNGATED else "pass" if ref else "ungated")
        if (ref is not None and rep["sequence"] in UNGATED and "error" not in rep
                and rep["AUC@30"] < ref["AUC@30"] - LOWTEX_FLAG):
            verdict += f" (AUC more than {LOWTEX_FLAG:g} below JAX: root-cause it)"
        lines.append(f"{rep['sequence']:24s} port AUC {rep['AUC@30']:.3f} focal "
                     f"{rep['focal_rel_err_pct']:.3f}% ATE {rep['ate']:.4f} | {jax_cols} | "
                     f"{verdict}")
    names = {r["sequence"] for r in reports}
    if names == set(reference["rows"]):
        mean = float(np.mean([r["AUC@30"] for r in reports]))
        need = reference["aggregate"]["mean_AUC@30"] - AUC_SLACK
        passed = mean >= need
        ok &= passed
        lines.append(f"mean AUC@30 {mean:.4f} over {len(reports)} (JAX "
                     f"{reference['aggregate']['mean_AUC@30']:.4f}, gate >= {need:.4f}): "
                     f"{'pass' if passed else 'MISS'}")
    return lines, ok


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"no nvidia-smi reading ({e.__class__.__name__})"
    return out[0] if out else "nvidia-smi printed nothing"


def _f(v) -> str:
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def markdown(reports: list, agg: dict, reference: dict, card: str, device: str,
             verdicts: list) -> str:
    both = ("focal_rel_err_pct", "Racc@5", "Tacc@5", "AUC@30", "ate")
    cols = (["sequence", "frames", "outlier_frac", "inward", "focal_true", "focal_est"]
            + [f"{c} JAX / port" for c in both] + ["port wall_s", "pairs", "launches"])
    lines = [
        "# Hard evaluation suite through the PyTorch port",
        "",
        f"Card: {card} (`nvidia-smi --query-gpu=name,power.limit`). Device: {device}.",
        "Made by `python scripts/eval_suite_torch.py OUT_DIR --compare`. The JAX",
        "columns are `eval_suite_results.json` (JAX package, float32, on a TPU); its",
        "TPU walls are not shown. The port's wall is frames in memory to files",
        "written, render excluded. Gates: the docstring of scripts/eval_suite_torch.py.",
        "",
        "| " + " | ".join(cols) + " |",
        "|" + "|".join(["---"] * len(cols)) + "|",
    ]
    for rep in reports:
        ref = reference["rows"].get(rep["sequence"], {})
        row = [_f(rep.get(c)) for c in cols[:6]]
        row += [f"{_f(ref.get(c, '-'))} / {_f(rep.get(c))}" for c in both]
        row += [_f(rep.get("wall_s")), _f(rep.get("pairs", "-")), _f(rep.get("launches", "-"))]
        lines.append("| " + " | ".join(row) + " |")
    lines += ["", "Port aggregate: " + json.dumps(agg),
              "", "JAX aggregate: " + json.dumps(reference["aggregate"]),
              "", "Comparison:", "", "```", *verdicts, "```", ""]
    return "\n".join(lines)


def main(argv=None, root: str = ROOT) -> int:
    args = parse_args(argv)
    specs = suite.QUICK_SEQUENCES if args.quick else suite.SEQUENCES
    if args.only:
        known = {s["name"] for s in specs}
        unknown = sorted(set(args.only) - known)
        if unknown:
            raise SystemExit(f"unknown sequences {unknown}; known: {sorted(known)}")
        specs = [s for s in specs if s["name"] in args.only]
    reports = run_suite(specs, args.out_dir, resume=args.resume, device=args.device)
    agg = suite.aggregate(reports)
    print(json.dumps(agg, indent=2), flush=True)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "suite.json"), "w") as f:
        json.dump({"per_sequence": reports, "aggregate": agg}, f, indent=2)

    reference = load_reference(args.compare or REFERENCE)
    lines, ok = compare(reports, reference)
    if args.compare:
        print("\n".join(lines), flush=True)
    if not args.quick and not args.only:
        card = card_line()
        with open(os.path.join(root, "eval_suite_torch_results.json"), "w") as f:
            json.dump({"card": card, "device": args.device or "cuda", "per_sequence": reports,
                       "aggregate": agg}, f, indent=2)
        with open(os.path.join(root, "EVAL_SUITE_TORCH.md"), "w") as f:
            f.write(markdown(reports, agg, reference, card, args.device or "cuda", lines))
    return 0 if ok or not args.compare else 1


if __name__ == "__main__":
    sys.exit(main())
