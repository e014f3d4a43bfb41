"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and the exit code is
non-zero):
  1. device  — require CUDA, TF32 off, print the card's name and power limit;
  2. build   — compile every CUDA source of the port with nvcc, all at
               once: csrc/two_nn_wgmma.cu (bf16, the main path's matcher),
               csrc/two_nn.cu (float32 FMAs, the matcher's exact checker) and
               csrc/spherical_polish.cu (RANSAC's final rotation polish);
  3. kernel  — both kernels against their plain PyTorch version on the card
               at 32 pairs × 1024 (the main path's chunk) and 32 pairs ×
               4000 (the default keypoint count), and on a ragged 8 × 1000
               case with invalid rows: bf16 distances to atol 1e-4 with
               identical indices where the plain version's m2 − m1 > 2e-4,
               float32 to atol 1e-5 with identical indices, +inf on invalid
               queries, bf16 ratio-test agreement with float32 > 0.99; then,
               at both shapes, the bf16 kernel's time beside the plain
               version's, a library yardstick's (bf16 torch.bmm → 2 − 2·ip +
               bias → torch.topk) and its tensor-core bound, and the float32
               kernel's time beside the same yardstick in float32 (TF32 off)
               and its FP32 bound;
  3a. polish — the final-polish kernel against the plain PyTorch path on
               the card at the main path's chunk (128 pairs × 1024 matches,
               30–70% outliers, float64), `polish_agreement`: LM iterations
               equal on ≥ 99% of pairs, the rotations of those pairs within
               1e-9 relative, the accepted flags equal but at ties, the
               inlier rows equal off the threshold, the kept scores and
               models within 1e-9, model and score untouched where not
               accepted; the kernel's time beside the plain path's and its
               FP64 bound (`polish_flops`), and its launches;
  4. main    — the calibrated driver on a rendered 48-frame 640×480 capture
               (focal 512, 1024 keypoints, exhaustive matching of 1128
               pairs); ATE < 0.05, median relative rotation error < 2°,
               output files present, one matcher launch per 32-pair chunk
               and one polish launch per 128-pair RANSAC chunk (9). The
               pairwise stage's seconds and peak device memory. Every phase
               that runs pairwise RANSAC below holds the polish to one
               launch a part of each chunk (`polish_parts`) the same way.
  4a. determinism — ROADMAP C26: the main phase's frames detected twice
               (1024 keypoints) and its rotation graph averaged twice by the
               dense solver and twice by the PCG, each pair bit for bit.
  4b. static_ransac — the main phase's capture again through the
               calibrated driver with cfg.ransac.adaptive=False (the static
               engine, 1024 hypotheses): the same gates and 36 launches; then
               the adaptive run once more, warm (`adaptive_warm`), so both
               engines' pairwise seconds and peak memory come from one
               process.
  5. match_k4000 — detect_features and match_pairs on the main phase's 48
               frames at the default 4000 keypoints (exhaustive, 1128
               pairs, 36 launches): matcher seconds, and the agreement of
               the accepted (pair, query, train) matches between the kernel
               and the plain version on the card, ≥ 0.99.
  5a. mesh  — the sharded stages on four logical shards of the card,
               Mesh((cuda:0,) * 4), each beside the single-device run in the
               same process (times labelled "logical shards on one card",
               not a multi-GPU speed): detect_features and match_pairs on
               the main phase's 48 frames bit for bit (144 bf16 launches,
               one per shard and 32-pair chunk), estimate_pairwise within
               the JAX test's bounds (identical keep, inliers within 3,
               rotations within 0.1°), retriangulation of the map the
               calibrated driver builds (the same successes, points within
               1e-5), SfMMap.optimize within 1e-6 relative cost and
               repeating bit for bit; the ring matcher (ring_match_pairs)
               equal on every pair to the float32 match_pairs_compact (16
               float32 kernel launches) and one ring step's kernel output
               against its plain version (atol 1e-5); the ba_scale scene
               through distributed_bundle_adjust: within 1e-3 of the
               single-device PCG's cost, below 0.5 × the initial cost, a
               repeat bit for bit. With two or more cards it also runs the
               calibrated driver with cfg.devices at the main phase's
               gates; with one it prints visible_cards 1 and
               driver_on_mesh "needs ≥ 2 cards".
  5b. multihost — tests/_torch_multihost_worker.py in a subprocess joined
               by initialize_distributed to a one-rank NCCL group (the
               env-var launch recipe), on a 2-shard mesh, dense and PCG:
               bit-equal to the same run in this process without a group,
               the PCG within 1e-6 (or JAX's 1e-18 floor) of the dense.
  6. uncalibrated — four sequences of the evaluation suite
               (sphericalsfm_tpu_torch/eval/suite.py, the port's counterpart
               of scripts/eval_suite.py) at their full 640×480 size through
               suite.run_sequence: the uncalibrated driver with windows
               matching, one line each: base_f560_120, wide_f280_100 (focal
               2× below the (W+H)/2 guess), out30_f560_120 (30% injected
               outlier matches) and inward_out20_f450_100 (inward-facing,
               20% outliers). Each must reach AUC@30 ≥ 98.8 against the
               rendered ground truth, relative focal error < 1%,
               ATE < 0.05, every output file, and one matcher launch per
               32-pair chunk of its windows pairs. All 14 sequences run
               through scripts/eval_suite_torch.py.
  7. modes   — the uncalibrated driver's other modes on a 24-frame
               320×240 render (true focal 260, guess 280): five-point
               pairwise and six-point focal within 15%, and a run from a
               COLMAP database written by the port from its own frontend
               within 5%. The five-point run must take eig_real_batched
               (the "qr" method, "auto" on CUDA).
  7a. solvers — the solver bench: the JAX bench's RANSAC workload (64 pairs
               × 256 correspondences, 2°, 1 px, 512 hypotheses; static and
               adaptive medians < 0.02°, pairs/s), its five-point workload
               (512 × 8, Sampson-disambiguated with cheirality; "qr" median
               < 0.5°, solves/s beside "eig"), eig_real_batched against
               torch.linalg.eig on 2048 float64 10×10 matrices (every real
               eigenvalue eig finds matched to 1e-8; both timed, and the
               parts and the eager launch cost), 7- and 8-point exact
               recovery, the solver-bench verb at 1000 trials, and the four
               comparison CSVs at the JAX defaults (no figures: no
               matplotlib there). Its RANSAC and
               five-point workloads and scoring are the round bench's
               (sphericalsfm_tpu_torch/eval/bench.py), here in float64.
  7b. bench  — the round bench's rows that no other phase holds (eval/bench.py,
               as bench_torch.py runs them): BA on the 64-camera bench scene
               (float32; cost after 20 iterations within 1e-3 of JAX's
               6521.95, converged in ≤ 12 iterations), the six-point shared
               focal solver (512 general-motion problems, float32; median
               focal error ≤ JAX's 7.419% + 1), detection ms per frame (the
               marginal of 8 640×480 frames over 2; positive or null) and the
               matcher at 8 and 16 pairs × K = 4096 (bf16 at 8 pairs against
               its plain version to atol 1e-4, float32 at 16 pairs to 1e-5,
               bf16/f32 nearest-neighbour identity 1.0 and ratio-test
               agreement ≥ 0.99); one line per row with its gates, and both
               kernels launched.
  8. flow    — Horn–Schunck flow at 640×480 (4 levels × 60 iterations):
               the shift-recovery case of tests/test_panorama.py (median u
               within 0.35 px of 3, median |v| < 0.3), and one keyframe
               pair's forward and backward flows on the card against the
               same function on the CPU (99th percentile |Δ| < 1e-3 px).
  9. panorama — make_stereo_panoramas on (a) BASELINE.md config (5) as
               scripts/bench_panorama.py defines it (32 rendered frames at
               640×480, focal 0.8·W, ground-truth poses, 5 panoramas × 2048
               columns), cold and warm, and (b) the user workflow: the
               poses.txt and frames of the `main` phase's calibrated run at
               the CLI defaults (2048 columns, nphi 9). Every output file,
               each cylindrical panorama more than 80% filled; one pair's
               columns on the card against the CPU (PSNR ≥ 40 dB, same valid
               mask); stage seconds and the flows' share of the wall.
  10. circle_views — 64 views from (b): at least 75% written, each written
               view more than 50% non-zero.
  11. ba_scale — the JAX package's large-scale BA at full width
               (scripts/bench_ba_scale.py: 2000 cameras × 520 observations,
               131,072 points, ~1.04M live observations, float32): (a)
               camera_solver="auto" with the bench's PCG settings (rtol
               1e-2, 25 CG iterations, 15 LM iterations), cold and warm; (b)
               the exact dense solve on the same problem upcast to float64;
               (c) (a) with the coarse
               level (groups of 16); (d) the checkpointed run stopped after
               one 5-iteration segment and resumed. "auto" must resolve to
               the PCG; (a) and (c) end below 0.5 × the initial cost and at
               most 1.3 × (b)'s; (d) within 1e-6 relative cost of an
               uninterrupted segmented run. CUDA-event times of one
               assembly, matvec and preconditioner apply beside the
               matvec's memory bound.
  12. long_capture — the calibrated driver on a rendered 540-frame 640×480
               sweep (focal 560, 1024 keypoints, windows matching of 2514
               pairs), cold, with cfg.profile_dir: ATE < 0.05, median
               relative rotation error < 2°, rotation averaging and all
               four BA passes on the PCG (counted), 79 matcher launches,
               every output file, a non-empty trace (device busy share read
               from it); then the joint rotations + focal graph on the run's
               rotation graph from multiplier 1.0 in [0.5, 2.0] with the PCG
               and the dense solve, on the measured relative rotations and
               on the ground truth's: the two solvers' multipliers within
               1e-3 of each other on both, and within 1% of 1.0 on the
               ground truth's (the measured edges of 1.3° and 2° come out
               3–6% short, so the measured graph's optimum is ~1.036).
Then one JSON line describing the kernels: the two matchers (launches per
phase, times and bound at both shapes) and the polish (its launches on the
main path and by phase, and the polish phase's times and bound), the card's
name and power limit, and last the result line {"ok": true, "device":
{...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHUNK = 32  # pairs per matcher launch on the main path


def phase(phase_name: str, **info):
    print(json.dumps({"phase": phase_name, **info}), flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_counts(two_nn):
    """Zero the matcher's launch counts and the final polish's."""
    from sphericalsfm_tpu_torch.ransac.polish_kernel import spherical_polish

    two_nn.launches = 0
    two_nn.route_launches.update(dict.fromkeys(two_nn.route_launches, 0))
    spherical_polish.launches = 0


def polish_launches() -> int:
    from sphericalsfm_tpu_torch.ransac.polish_kernel import spherical_polish

    return spherical_polish.launches


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call: the card first sleeps while the host
    queues every call, so host overhead between calls is not timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def descriptor_table(seed: int, pairs: int, K: int, noise: float = 0.05):
    """Frame table for `pairs` pairs: frame b (train) against frame pairs+b
    (queries: a permuted, noisy copy), unit-norm float32 descriptors."""
    rng = np.random.default_rng(seed)
    d0 = rng.normal(size=(pairs, K, 128)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 = d0[:, rng.permutation(K)] + rng.normal(size=(pairs, K, 128)).astype(np.float32) * noise
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return np.concatenate([d0, d1]), torch.arange(pairs), torch.arange(pairs) + pairs


# (name, pairs, K, share of invalid rows): the main path's chunk, the
# default keypoint count, and a ragged case
KERNEL_CASES = (("32x1024", 32, 1024, 0.0), ("32x4000", 32, 4000, 0.0),
                ("ragged1000", 8, 1000, 0.05))
# (dtype, distance tolerance, index gap): bf16 inputs with f32 sums taken in
# another order than the plain version's; float32 sums in another order
TOLERANCES = ((torch.bfloat16, 1e-4, 2e-4), (torch.float32, 1e-5, 1e-5))
H100_BF16_FLOPS = 989e12   # dense, 700 W (NVIDIA's data sheet)
H100_FP32_FLOPS = 67e12    # outside the tensor cores, 700 W (the same sheet)
H100_FP64_FLOPS = 33.5e12  # FP64 outside the tensor cores, 700 W (the same sheet)
H100_HBM_BYTES = 3.35e12


def compare_two_nn(name, got, ref, qvalid, atol, gap):
    """Distances to `atol` on valid queries, identical indices where the
    plain version's m2 − m1 > gap, +inf on invalid queries. Returns the
    largest distance error."""
    (m1, m2, nn), (r1, r2, rn) = got, ref
    err = max(float((m1[qvalid] - r1[qvalid]).abs().max()),
              float((m2[qvalid] - r2[qvalid]).abs().max()))
    sep = qvalid & (r2 - r1 > gap)
    same_idx = bool(torch.equal(nn[sep], rn[sep]))
    inv_ok = bool(torch.isinf(m1[~qvalid]).all() and torch.isinf(m2[~qvalid]).all())
    if not err <= atol or not same_idx or not inv_ok:
        raise AssertionError(f"kernel != plain version on {name}: max err {err}, "
                             f"indices equal {same_idx}, invalid queries inf {inv_ok}")
    return err


def accepted(out, qvalid, ratio=0.75):
    m1, m2, nn = out
    return (m1 < ratio * ratio * m2) & torch.isfinite(m1) & qvalid, nn


def match_agreement(a, b, qvalid):
    """|∩| / |∪| of the ratio-test-accepted (pair, query, train) matches."""
    (acc_a, nn_a), (acc_b, nn_b) = accepted(a, qvalid), accepted(b, qvalid)
    both = int((acc_a & acc_b & (nn_a == nn_b)).sum())
    return both, int(acc_a.sum()) + int(acc_b.sum()) - both


def check_kernel(two_nn, reference, device="cuda"):
    """Both kernels against the plain version on every case, and bf16
    against float32 on the ratio test. Returns the summary and the cases'
    tables (bf16 copies for timing)."""
    dev = torch.device(device)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    cases, tables = [], {}
    for seed, (name, pairs, K, drop) in enumerate(KERNEL_CASES):
        desc, pi, pj = descriptor_table(seed, pairs, K)
        rng = np.random.default_rng(10 + seed)
        valid = torch.as_tensor(rng.uniform(size=desc.shape[:2]) >= drop, device=dev)
        desc_t = torch.as_tensor(desc, device=dev)
        pi, pj = pi.to(dev), pj.to(dev)
        qvalid = valid[pj]
        outs, errs = {}, {}
        for dtype, atol, gap in TOLERANCES:
            outs[dtype] = two_nn(desc_t, valid, pi, pj, dtype)
            ref = reference(desc_t, valid, pi, pj, dtype)
            sync(dev)
            errs[str(dtype)[6:]] = compare_two_nn(f"{name} {dtype}", outs[dtype], ref, qvalid,
                                                  atol, gap)
            worst[dtype] = max(worst[dtype], errs[str(dtype)[6:]])
            del ref
        both, union = match_agreement(outs[torch.bfloat16], outs[torch.float32], qvalid)
        agree = both / max(union, 1)
        if not agree > 0.99:
            raise AssertionError(f"{name}: bf16 ratio-test agreement {agree:.4f} <= 0.99")
        cases.append(dict(case=name, max_abs_err=errs, bf16_f32_agreement=agree))
        tables[name] = (desc_t.to(torch.bfloat16), valid, pi, pj)
        del outs
    return dict(max_abs_err=worst[torch.bfloat16], f32_max_abs_err=worst[torch.float32],
                cases=cases), tables


def library_two_nn(desc, valid, pair_i, pair_j):
    """Yardstick for the kernels' time, never called by the port: torch.bmm
    in the table's dtype (bf16, or float32 with TF32 off as the port sets
    it) on the gathered copies → 2 − 2·ip + bias → torch.topk."""
    pi, pj = pair_i.long(), pair_j.long()
    ip = torch.bmm(desc[pj], desc[pi].transpose(1, 2)).float()
    bias = torch.where(valid[pi], 0.0, float("inf"))
    vals, inds = torch.topk(2.0 - 2.0 * ip + bias[:, None, :], 2, dim=-1, largest=False)
    m1, m2 = vals[..., 0], vals[..., 1]
    idx = torch.where(torch.isfinite(m1), inds[..., 0], -1).to(torch.int32)
    qvalid = valid[pj]
    return (torch.where(qvalid, m1, float("inf")), torch.where(qvalid, m2, float("inf")), idx)


def two_nn_bound(desc, valid, pair_i, pair_j, peak=H100_BF16_FLOPS, elem_bytes=2):
    """Least time on an H100 for the function on these inputs: the larger
    of its operations over `peak` (the bf16 tensor cores by default) and
    its bytes (each frame's descriptors of `elem_bytes` and validity read
    once, pair lists read, outputs written once) over the memory rate.
    Returns (ms, bound_by)."""
    P, K = pair_i.numel(), desc.shape[1]
    frames = torch.unique(torch.cat([pair_i, pair_j])).numel()
    ops = 2.0 * P * K * K * desc.shape[2]
    nbytes = frames * K * (desc.shape[2] * elem_bytes + 1) + 2 * P * 4 + P * K * 12
    t_ops, t_bytes = ops / peak, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def two_nn_f32_bound(desc, valid, pair_i, pair_j):
    """The float32 route's bound: its operations on the FP32 pipe (67
    TFLOP/s), 4 B a descriptor element."""
    return two_nn_bound(desc, valid, pair_i, pair_j, H100_FP32_FLOPS, 4)


def time_kernel(two_nn, reference, args):
    """At one shape: the bf16 kernel, the float32 FMA kernel, the plain
    version and the library yardstick in bf16 and in float32 (TF32 off, as
    resolve_device("cuda") sets it), in turns (each timed twice, the
    minimum reported), and both routes' bounds."""
    desc, valid, pi, pj = args
    desc32 = desc.float()
    # the main path checks its pair list once per match_pairs call, not per
    # launch; an older checkout timed by scripts/bench_two_nn.py --root has
    # no such switch and is timed with its per-launch check
    kw = {"check_pairs": False} if "check_pairs" in inspect.signature(two_nn).parameters else {}
    fns = dict(
        ms=lambda: two_nn(desc, valid, pi, pj, torch.bfloat16, **kw),
        fma_f32_ms=lambda: two_nn(desc32, valid, pi, pj, torch.float32, **kw),
        plain_ms=lambda: reference(desc, valid, pi, pj, torch.bfloat16),
        plain_f32_ms=lambda: reference(desc32, valid, pi, pj, torch.float32),
        library_ms=lambda: library_two_nn(desc, valid, pi, pj),
        library_f32_ms=lambda: library_two_nn(desc32, valid, pi, pj),
    )
    order = ["plain_ms", "ms", "fma_f32_ms", "library_ms", "library_f32_ms", "plain_f32_ms"]
    runs = {k: [] for k in order}
    for k in order + order[::-1]:
        runs[k].append(cuda_ms(fns[k], reps=20 if k in ("ms", "plain_ms", "library_ms") else 10))
    out = {k: min(v) for k, v in runs.items()}
    out["bound_ms"], out["bound_by"] = two_nn_bound(desc, valid, pi, pj)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["f32_bound_ms"], out["f32_bound_by"] = two_nn_f32_bound(desc, valid, pi, pj)
    out["f32_share_of_bound"] = out["f32_bound_ms"] / out["fma_f32_ms"]
    out["runs"] = runs
    return out


# Floating-point operations a match of the final polish (csrc/spherical_polish.cu),
# counted from its arithmetic; a dual number is a value and 3 tangents, so a
# dual × scalar is 4 products, a dual sum 4 sums, a dual product 10 and a
# dual quotient 10 operations.
POLISH_JACOBIAN_FLOPS = 213  # E u and Eᵀv's first two (5 rows × (3 dual × scalar + 2 dual
#                              sums) = 100), vᵀEu (20), the denominator (4 dual squares
#                              + 3 dual sums = 52), d²/den (20); 3 weights and 9
#                              products summed into JᵀWJ and JᵀWs (21)
POLISH_COST_FLOPS = 42       # the same in values (39) and w·s² summed (3)
POLISH_RESCORE_FLOPS = 40    # the Sampson error (39) and the capped sum (1)


def polish_flops(iterations, N: int) -> float:
    """Operations of one polish call: for each pair, its first cost, then
    per LM iteration a Jacobian evaluation and a cost, then the rescoring,
    each over its N matches. `iterations` holds each pair's count."""
    it = float(iterations.sum())
    pairs = iterations.numel()
    return N * (POLISH_COST_FLOPS * (pairs + it) + POLISH_JACOBIAN_FLOPS * it
                + POLISH_RESCORE_FLOPS * pairs)


def polish_inputs(B, N, dtype=torch.float64, inward=False, seed=0, device="cuda",
                  rotation_deg=-1.0, outliers=(0.3, 0.7)):
    """The final polish's inputs at B pairs × N matches: rays of random
    spherical problems (1 px noise at f = 600; rotations uniform in [0, π)
    by default) with a share of outliers drawn per pair from `outliers`,
    through the adaptive engine on `device` without its polish. Returns
    (r0, u, v, mask, inliers, E, score, sq_thresh)."""
    from sphericalsfm_tpu_torch.eval.synthetic import make_random_problems
    from sphericalsfm_tpu_torch.geometry.essential import decompose_spherical_essential
    from sphericalsfm_tpu_torch.ransac.spherical import spherical_ransac_adaptive

    prob = make_random_problems(torch.Generator().manual_seed(seed), B, N, inward=inward,
                                rotation_deg=rotation_deg, point_noise=1.0 / 600, device="cpu")
    rng = np.random.default_rng(seed)
    out = rng.uniform(size=(B, N)) < rng.uniform(*outliers, size=(B, 1))
    v = prob.v.numpy().copy()
    v[..., :2] = np.where(out[..., None], rng.normal(size=(B, N, 2)) * 0.5, v[..., :2])
    u, v = (torch.as_tensor(x, dtype=dtype, device=device) for x in (prob.u.numpy(), v))
    mask = prob.valid.to(device)
    sq = (2.0 / 600) ** 2
    res = spherical_ransac_adaptive(torch.Generator(device=device).manual_seed(seed + 1), u, v,
                                    mask, sq, max_rounds=79, inward=inward,
                                    final_least_squares=False)
    r0, _ = decompose_spherical_essential(res.E, inward=inward)
    return r0.contiguous(), u, v, mask, res.inlier_mask, res.E, res.score, sq


def polish_agreement(args, k, p, inward=False, min_equal=0.99):
    """The kernel's polish `k` against the plain path's `p` on the float64
    inputs `args` (polish_inputs' tuple): the measures and the failures
    among them. Both paths run the same arithmetic summed in another order:
    LM iterations equal on ≥ `min_equal` of pairs (an accept test flips
    only at rounding level, near a minimum), rotations with equal iterations
    within 1e-9 relative; the accepted flags equal outside ties (the
    polished score within 1e-9 relative of the RANSAC score, or within
    1e-12 of one capped match: a pair whose few valid matches fit exactly
    scores ~1e-32, rounding alone); the inlier rows of pairs with equal
    flags equal outside matches within 1e-9 relative of the threshold; the
    scores (1e-9 relative) and models (1e-9) of pairs both kept with equal
    iterations; and the input model and score left as they were where the
    kernel did not accept."""
    from sphericalsfm_tpu_torch.geometry.essential import make_spherical_essential
    from sphericalsfm_tpu_torch.geometry.so3 import so3_exp
    from sphericalsfm_tpu_torch.ransac.engine import msac_score
    from sphericalsfm_tpu_torch.ransac.spherical import sampson_error

    r0, u, v, mask, inliers, E, score, sq = args
    same = k.iterations == p.iterations
    rel = (torch.linalg.norm(k.r - p.r, dim=-1)
           / torch.linalg.norm(p.r, dim=-1).clamp(min=1e-300))
    errs = sampson_error(make_spherical_essential(so3_exp(p.r), inward=inward), u, v)
    tie = (msac_score(errs, sq, mask) - score).abs() <= 1e-9 * score.abs() + 1e-12 * sq
    rows = k.accepted == p.accepted
    near = (errs - sq).abs() <= 1e-9 * sq
    kept = k.accepted & p.accepted & same
    score_ok = (k.score - p.score).abs() <= 1e-9 * p.score.abs() + 1e-12 * sq
    E_err = (k.E - p.E).abs().flatten(1).amax(-1)
    left = ~k.accepted
    info = dict(iters_equal_share=float(same.double().mean()),
                r_rel_max_equal_iters=float(rel[same].max()) if same.any() else None,
                r_rel_max=float(rel.max()),
                accepted_share=float(k.accepted.double().mean()),
                accepted_ties=int(tie.sum()),
                accepted_differ=int((k.accepted != p.accepted)[~tie].sum()),
                inliers_differ=int(((k.inliers != p.inliers) & ~near)[rows].sum()),
                kept_both=int(kept.sum()),
                kept_score_differ=int((~score_ok)[kept].sum()),
                kept_E_max_abs_err=float(E_err[kept].max()) if kept.any() else 0.0,
                unaccepted_changed=int(((k.E != E).flatten(1).any(-1)
                                        | (k.score != score))[left].sum()))
    failures = []
    if info["iters_equal_share"] < min_equal:
        failures.append(f"LM iterations equal on {info['iters_equal_share']:.3f} of pairs")
    if info["r_rel_max_equal_iters"] is None or not info["r_rel_max_equal_iters"] <= 1e-9:
        failures.append(f"rotations differ by {info['r_rel_max_equal_iters']} relative")
    if info["accepted_differ"]:
        failures.append(f"accepted flags differ outside ties on {info['accepted_differ']} pairs")
    if info["inliers_differ"]:
        failures.append(f"{info['inliers_differ']} inlier flags differ off the threshold")
    if info["kept_score_differ"]:
        failures.append(f"scores of {info['kept_score_differ']} kept pairs differ")
    if not info["kept_E_max_abs_err"] <= 1e-9:
        failures.append(f"kept models differ by {info['kept_E_max_abs_err']}")
    if info["unaccepted_changed"]:
        failures.append(f"{info['unaccepted_changed']} pairs not accepted changed model or score")
    return info, failures


def run_polish_phase(device="cuda", B=128, N=1024):
    """The final-polish kernel against the plain path on the card at the
    main path's chunk: agreement (`polish_agreement`), times and the FP64
    bound. Returns the phase's line."""
    from sphericalsfm_tpu_torch.ransac import spherical as sph
    from sphericalsfm_tpu_torch.ransac.polish_kernel import spherical_polish

    args = polish_inputs(B, N, device=device)
    before = spherical_polish.launches
    k = sph._polish(*args, False, 25)
    p = sph._polish_plain(*args, False, 25)
    sync(device)
    launches = spherical_polish.launches - before
    agreement, failures = polish_agreement(args, k, p)
    info = dict(pairs=B, matches=N, dtype="float64", launches=launches,
                iters_mean=float(k.iterations.double().mean()),
                plain_iters_mean=float(p.iterations.double().mean()), **agreement)
    info["ms"] = cuda_ms(lambda: spherical_polish(*args, False, 25))
    info["plain_ms"] = cuda_ms(lambda: sph._polish_plain(*args, False, 25), reps=3, warmup=1)
    flops = polish_flops(k.iterations, N)
    info.update(flops=flops, bound_ms=flops / H100_FP64_FLOPS * 1e3, bound_by="operations")
    info["share_of_bound"] = info["bound_ms"] / info["ms"]
    phase("polish", **info, failures=failures)
    if launches != 1:
        failures.append(f"{launches} launches for one call")
    if failures:
        raise RuntimeError("polish phase: " + "; ".join(failures))
    return info


def polish_parts(pairs: int, chunk: int, devices: int = 0) -> int:
    """Polish launches of one pairwise RANSAC sweep: one a part of each
    chunk, a chunk grown with the mesh and split over its shards as
    `estimate_pairwise` grows and splits it."""
    nd = max(devices, 1)
    if devices:
        chunk = -(-chunk // nd) * nd * max(1, nd // 8)
    return sum(min(nd, pairs - s) for s in range(0, pairs, chunk))


class DriverProbe:
    """Wraps the calibrated driver's `estimate_pairwise` (its seconds and
    peak device memory, from a reset of the peak counter) and
    `optimize_rotations` (its inputs, the rotation graph) for one run."""

    def __init__(self, device="cuda"):
        from sphericalsfm_tpu_torch.pipeline import driver

        self.driver, self.device, self.info = driver, device, {}

    def __enter__(self):
        d = self.driver
        self.real = (d.estimate_pairwise, d.optimize_rotations)

        def pairwise(*a, **kw):
            sync(self.device)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = self.real[0](*a, **kw)
            sync(self.device)
            self.info.update(pairwise_s=time.perf_counter() - t0,
                             pairwise_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             pairwise_peak_above_start_gib=(torch.cuda.max_memory_allocated()
                                                            - base) / 2**30)
            return out

        def rotations(rot0, g, *a, **kw):
            self.info.update(rot0=rot0, graph=g)
            return self.real[1](rot0, g, *a, **kw)

        d.estimate_pairwise, d.optimize_rotations = pairwise, rotations
        return self.info

    def __exit__(self, *exc):
        self.driver.estimate_pairwise, self.driver.optimize_rotations = self.real


def main_config(static: bool = False):
    """The main phase's calibrated configuration; `static` takes the static
    RANSAC engine at its default budget of 1024 hypotheses."""
    from sphericalsfm_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.frontend.max_keypoints = 1024
    cfg.frontend.max_matches_per_pair = 512
    cfg.ransac.num_hypotheses = 1024 if static else 512
    cfg.ransac.adaptive = not static
    cfg.ransac.min_num_inliers = 30
    cfg.ba.max_iters = 60
    return cfg


def run_main_path(two_nn, device="cuda", F=48, W=640, H=480, static=False, phase_name=None,
                  devices=0):
    from sphericalsfm_tpu_torch.eval.metrics import ate, rotation_error_deg
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp
    from sphericalsfm_tpu_torch.pipeline.driver import run_calibrated

    focal = 0.8 * W
    t0 = time.perf_counter()
    cam_r, cam_t, gray, color = render_capture(num_frames=F, focal=focal, width=W, height=H,
                                               wave_freq=25.0 * (W / 320), device=device)
    render_s = time.perf_counter() - t0

    cfg = main_config(static)
    cfg.devices = devices
    pairs = F * (F - 1) // 2
    # one launch per chunk, or per shard and chunk on a mesh
    chunks = sum(min(max(devices, 1), pairs - s) for s in range(0, pairs, CHUNK))
    polish_expected = polish_parts(pairs, cfg.ransac.pair_chunk, devices)
    with tempfile.TemporaryDirectory() as out, DriverProbe(device) as probe:
        reset_counts(two_nn)
        t0 = time.perf_counter()
        m = run_calibrated(None, Intrinsics(focal, W / 2.0, H / 2.0), out, cfg,
                           gray=gray, color=color, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = two_nn.launches, dict(two_nn.route_launches)
        polish = polish_launches()
        with open(os.path.join(out, "poses.txt")) as f:
            poses_txt = f.read()
        missing = [f for f in ("poses.txt", "points.obj", "cameras.obj", "summary.json",
                               "stages.jsonl", "frontend.npz", "sparse/model/cameras.txt",
                               "sparse/model/images.txt", "sparse/model/points3D.txt")
                   if not os.path.exists(os.path.join(out, f))]
        stages = [json.loads(line) for line in open(os.path.join(out, "stages.jsonl"))]
        with open(os.path.join(out, "summary.json")) as f:
            summary = json.load(f)

    R_gt = np_so3_exp(cam_r)
    centers_gt = -np.einsum("cji,cj->ci", R_gt, cam_t)
    err = float(ate(m.centers(), centers_gt))
    R = np_so3_exp(m.cam_r)
    rel = rotation_error_deg(np.einsum("nij,kj->nik", R, R[0]),
                             np.einsum("nij,kj->nik", R_gt, R_gt[0])).numpy()
    ba = {k: v for s in stages for k, v in s.items() if k.endswith("_final_cost")
          or k.endswith("_initial_cost") or k.endswith("_iterations")}
    pw = {k: v for k, v in probe.items() if k.startswith("pairwise")}
    counts = [s for s in stages if s["stage"] == "estimate_pairwise"][-1]
    info = dict(frames=F, size=f"{W}x{H}", pairs=pairs,
                engine="static" if static else "adaptive",
                num_hypotheses=cfg.ransac.num_hypotheses, wall_s=round(wall, 3),
                render_s=round(render_s, 3), ate=err, median_rel_rot_deg=float(np.median(rel)),
                points=int(m.point_valid().sum()), summary=summary, launches=launches,
                route_launches=routes, expected_launches=chunks, polish_launches=polish,
                expected_polish_launches=polish_expected,
                **{k: counts.get(k) for k in ("chunks", "polish_iters", "polish_accept_pct")},
                stage_s={s["stage"]: s["seconds"] for s in stages}, ba=ba, **pw)
    phase(phase_name or ("static_ransac" if static else "main"), **info)
    if missing:
        raise AssertionError(f"outputs missing: {missing}")
    if not err < 0.05:
        raise AssertionError(f"ATE {err} >= 0.05")
    if not np.median(rel) < 2.0:
        raise AssertionError(f"median relative rotation error {np.median(rel)} >= 2 deg")
    if launches != chunks or routes["wgmma_bf16"] != chunks:
        raise AssertionError(f"matcher launched {routes}, expected {chunks} bf16 launches")
    if polish != polish_expected:
        raise AssertionError(f"polish launched {polish} times, expected {polish_expected}")
    # the calibrated run's output is the stereo-panorama workflow's input
    return launches, dict(poses_txt=poses_txt, gray=gray, color=color,
                          intrinsics=(focal, W / 2.0, H / 2.0), launches=launches,
                          polish_launches=polish,
                          rot0=probe["rot0"], graph=probe["graph"], pairwise=pw)


def run_determinism_phase(gray, color, graphs, device="cuda", reps=2):
    """ROADMAP C26: the frames detected `reps` times at 1024 keypoints, and
    each rotation graph of `graphs` (name -> (rot0, graph, solver))
    averaged `reps` times, each set of runs compared bit for bit; seconds
    of each run. The smoke passes the main phase's 48 frames and its graph
    under both solvers (dense, as the driver ran it, and the PCG)."""
    from sphericalsfm_tpu_torch.config import FrontendConfig
    from sphericalsfm_tpu_torch.optim.pose_graph import optimize_rotations
    from sphericalsfm_tpu_torch.pipeline.frontend import detect_features

    cfg = FrontendConfig()
    cfg.max_keypoints = 1024
    runs, secs = [], []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        f = detect_features(gray, color, cfg, device=device)
        sync(device)
        secs.append(round(time.perf_counter() - t0, 4))
        runs.append(f)
    fields = ("xy", "descriptor", "valid", "color", "counts")
    detect_same = {k: all(np.array_equal(getattr(runs[0], k), getattr(r, k)) for r in runs[1:])
                   for k in fields}
    detect_same["descriptor_dev"] = all(torch.equal(runs[0].descriptor_dev, r.descriptor_dev)
                                        for r in runs[1:])
    rot = {}
    for name, (rot0, g, solver) in graphs.items():
        outs, rsecs = [], []
        for _ in range(reps):
            sync(device)
            t0 = time.perf_counter()
            rots, cost = optimize_rotations(rot0, g, solver=solver)
            sync(device)
            rsecs.append(round(time.perf_counter() - t0, 4))
            outs.append((rots, cost))
        rot[name] = dict(solver=solver, nodes=int(rot0.shape[0]), edges=int(g.edge_i.numel()),
                         live_edges=int((g.edge_w > 0).sum()), seconds=rsecs,
                         cost=float(outs[0][1]),
                         same=all(torch.equal(outs[0][0], o[0]) and torch.equal(outs[0][1], o[1])
                                  for o in outs[1:]))
    phase("determinism", frames=len(gray), keypoints=cfg.max_keypoints, detect_s=secs,
          detect_bit_identical=detect_same, rotation_init=rot)
    failures = [f"detect_features {k} differs between runs" for k, v in detect_same.items()
                if not v]
    failures += [f"optimize_rotations ({name}) differs between runs" for name, r in rot.items()
                 if not r["same"]]
    if failures:
        raise AssertionError(f"determinism failed: {failures}")


def run_match_k4000(two_nn, reference, gray, color, device="cuda", K=4000):
    """The main phase's frames through detect_features and match_pairs at
    the default keypoint count; then, chunk by chunk, the kernel's accepted
    matches against the plain version's on the same descriptors. Returns
    the launches of match_pairs."""
    from sphericalsfm_tpu_torch.config import FrontendConfig
    from sphericalsfm_tpu_torch.pipeline.frontend import detect_features, match_pairs
    from sphericalsfm_tpu_torch.pipeline.pairwise import all_pairs

    cfg = FrontendConfig()
    cfg.max_keypoints = K
    t0 = time.perf_counter()
    feats = detect_features(gray, color, cfg, device=device)
    sync(device)
    detect_s = time.perf_counter() - t0
    pair_i, pair_j = all_pairs(len(gray))
    pairs = len(pair_i)
    reset_counts(two_nn)
    t0 = time.perf_counter()
    _, _, mmask = match_pairs(feats, pair_i, pair_j, cfg, device=device)
    match_s = time.perf_counter() - t0
    launches, routes = two_nn.launches, dict(two_nn.route_launches)

    desc = feats.descriptor_dev.to(torch.bfloat16)
    valid = feats.valid_dev
    both = union = 0
    for s in range(0, pairs, CHUNK):
        pi = torch.as_tensor(pair_i[s:s + CHUNK], device=device)
        pj = torch.as_tensor(pair_j[s:s + CHUNK], device=device)
        b, u = match_agreement(two_nn(desc, valid, pi, pj, torch.bfloat16),
                               reference(desc, valid, pi, pj, torch.bfloat16), valid[pj.long()])
        both, union = both + b, union + u
    agree = both / max(union, 1)
    chunks = math.ceil(pairs / CHUNK)
    phase("match_k4000", frames=len(gray), keypoints=K, mean_valid=float(feats.counts.mean()),
          pairs=pairs, detect_s=round(detect_s, 3), match_s=round(match_s, 4),
          matches=int(mmask.sum()), launches=launches, route_launches=routes,
          expected_launches=chunks, accepted_agreement=agree, accepted_union=union)
    if launches != chunks or routes["wgmma_bf16"] != chunks:
        raise AssertionError(f"matcher launched {routes}, expected {chunks} bf16 launches")
    if not agree >= 0.99:
        raise AssertionError(f"kernel and plain version agree on {agree:.4f} < 0.99 of the "
                             "accepted matches")
    return launches


# sphericalsfm_tpu_torch.eval.suite SEQUENCES, four of fourteen
UNCALIB_SEQUENCES = ("base_f560_120", "wide_f280_100", "out30_f560_120",
                     "inward_out20_f450_100")
UNCALIB_OUTPUTS = ("calib.txt", "focal_costs.txt", "summary.json", "stages.jsonl",
                   "poses.txt", "points.obj", "cameras.obj") + tuple(
    f"sparse/{d}/{f}" for d in ("pre-spherical-ba", "pre-general-ba", "final", "model")
    for f in ("cameras.txt", "images.txt", "points3D.txt"))


def sequence_failures(rep, spec, out):
    """The smoke's gates on one evaluation-suite report."""
    missing = [f for f in UNCALIB_OUTPUTS if not os.path.exists(os.path.join(out, f))]
    failures = []
    if not rep["AUC@30"] >= 98.8:
        failures.append(f"AUC@30 {rep['AUC@30']} < 98.8")
    if not abs(rep["focal_est"] - spec["focal"]) / spec["focal"] < 0.01:
        failures.append(f"focal {rep['focal_est']} not within 1% of {spec['focal']}")
    if not rep["ate"] < 0.05:
        failures.append(f"ATE {rep['ate']} >= 0.05")
    if missing:
        failures.append(f"outputs missing: {missing}")
    if rep["launches"] != rep["expected_launches"]:
        failures.append(f"matcher launched {rep['launches']} times, expected "
                        f"{rep['expected_launches']}")
    if rep["polish_launches"] != rep["expected_polish_launches"]:
        failures.append(f"polish launched {rep['polish_launches']} times, expected "
                        f"{rep['expected_polish_launches']}")
    return failures


def run_uncalibrated_phase(two_nn, device="cuda"):
    """Four evaluation-suite sequences through suite.run_sequence (render,
    frontend, injected outliers, run_uncalibrated, evaluator), inward_out20
    the inward mode's; raises after all of them ran if any missed a bound.
    Returns the phase's matcher and polish launches."""
    from sphericalsfm_tpu_torch.eval import suite
    from sphericalsfm_tpu_torch.pipeline.frontend import window_pairs

    specs = {s["name"]: s for s in suite.SEQUENCES}
    failed = {}
    reset_counts(two_nn)
    with tempfile.TemporaryDirectory() as out_root:
        for name in UNCALIB_SEQUENCES:
            cfg = suite.sequence_config(specs[name])
            pairs = len(window_pairs(specs[name]["frames"], cfg.frontend.adjacent_window,
                                     cfg.graph.num_frames_begin, cfg.graph.num_frames_end)[0])
            before = polish_launches()
            rep = suite.run_sequence(specs[name], out_root, device)
            rep["expected_launches"] = math.ceil(pairs / CHUNK)
            rep["polish_launches"] = polish_launches() - before
            rep["expected_polish_launches"] = polish_parts(pairs, cfg.ransac.pair_chunk)
            failures = sequence_failures(rep, specs[name], os.path.join(out_root, name))
            phase("uncalibrated", **rep, failures=failures)
            if failures:
                failed[name] = failures
    launches, polish = two_nn.launches, polish_launches()
    if failed:
        raise AssertionError(f"uncalibrated sequences failed: {failed}")
    return launches, polish


def run_modes_phase(two_nn, device="cuda", F=24, W=320, H=240, focal=260.0):
    """Five-point, six-point and COLMAP-database runs of the uncalibrated
    driver on one small render, held to the bounds of the JAX package's
    driver tests. Returns the phase's matcher and polish launches: the
    five-point mode polishes with the generic LM, the others with the
    kernel, once a chunk of the `estimate_pairwise` record."""
    from sphericalsfm_tpu_torch.config import PipelineConfig
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.io.colmap import ColmapDatabase, write_database
    from sphericalsfm_tpu_torch.pipeline.driver import (
        StageLogger, run_frontend, run_uncalibrated,
    )

    _, _, gray, color = render_capture(num_frames=F, arc=1.0, focal=focal, width=W,
                                       height=H, device=device)

    def config(small: bool):
        cfg = PipelineConfig()
        cfg.frontend.max_keypoints = 384 if small else 512
        cfg.frontend.max_matches_per_pair = 256 if small else 384
        cfg.ransac.num_hypotheses = 128 if small else 384
        cfg.ransac.min_num_inliers = 25 if small else 30
        cfg.focal.num_trials = 128 if small else 256
        cfg.ba.max_iters = 40 if small else 60
        return cfg

    def colmap_db(cfg, out):
        fr = run_frontend(None, cfg, StageLogger(out), gray, color, device=device)
        counts = fr.feats.counts
        matches = {}
        for p in range(len(fr.pair_i)):
            mk = fr.mmask[p]
            if mk.sum() >= 5:
                matches[(int(fr.pair_i[p]), int(fr.pair_j[p]))] = np.stack(
                    [fr.idx0[p][mk], fr.idx1[p][mk]], -1).astype(np.int32)
        path = os.path.join(out, "features.db")
        write_database(path, ColmapDatabase(
            intrinsics=((W + H) / 2.0, W / 2.0, H / 2.0), width=W, height=H,
            names=[f"frame{f:04d}.png" for f in range(F)],
            keypoints=[fr.feats.xy[f][:counts[f]].astype(np.float32) for f in range(F)],
            descriptors=[fr.feats.descriptor[f][:counts[f]] for f in range(F)],
            matches=matches))
        return path

    from sphericalsfm_tpu_torch.solvers import five_point

    real_eig = five_point.eig_real_batched
    eig_calls = []

    def counted_eig(M):
        """eig_real_batched, counted and timed (synchronized each side)."""
        sync(device)
        t0 = time.perf_counter()
        out = real_eig(M)
        sync(device)
        eig_calls.append((M[..., 0, 0].numel(), time.perf_counter() - t0))
        return out

    failed = {}
    launches = polish = 0
    for mode, bound in (("five_point", 0.15), ("six_point", 0.15), ("colmap_db", 0.05)):
        cfg = config(small=mode != "colmap_db")
        with tempfile.TemporaryDirectory() as out:
            reset_counts(two_nn)
            eig_calls.clear()
            five_point.eig_real_batched = counted_eig
            t0 = time.perf_counter()
            try:
                if mode == "colmap_db":
                    m, est = run_uncalibrated(None, out, cfg, colmap_db=colmap_db(cfg, out),
                                              device=device)
                else:
                    setattr(cfg, mode, True)
                    m, est = run_uncalibrated(None, out, cfg, gray=gray, color=color,
                                              device=device)
                sync(device)
            finally:
                five_point.eig_real_batched = real_eig
            wall = time.perf_counter() - t0
            stages = [json.loads(line) for line in open(os.path.join(out, "stages.jsonl"))]
            ok_files = all(os.path.exists(os.path.join(out, f))
                           for f in ("calib.txt", "sparse/final/cameras.txt"))
        err = abs(est - focal) / focal
        fs = [s for s in stages if s["stage"] == "focal_search"][-1]
        pw = [s for s in stages if s["stage"] == "estimate_pairwise"][-1]
        mode_polish = polish_launches()
        polish_expected = 0 if mode == "five_point" else pw["chunks"]
        failures = []
        if not err < bound:
            failures.append(f"focal {est} not within {bound:.0%} of {focal}")
        if not ok_files:
            failures.append("calib.txt or sparse/final missing")
        if mode == "six_point" and not fs.get("sixpoint", {}).get("pairs_used", 0) > 0:
            failures.append("six-point RANSAC used no pairs")
        if two_nn.launches == 0:
            failures.append("matcher never launched")
        if mode == "five_point" and not eig_calls:
            failures.append("the five-point solver never took eig_real_batched")
        if mode_polish != polish_expected:
            failures.append(f"polish launched {mode_polish} times, expected {polish_expected}")
        launches += two_nn.launches
        polish += mode_polish
        extra = dict(eig_real_batched_calls=len(eig_calls),
                     eig_matrices=sum(n for n, _ in eig_calls),
                     eig_real_batched_s=round(sum(s for _, s in eig_calls), 3),
                     wall_s_on_torch_linalg_eig="34-44") if mode == "five_point" else {}
        phase("modes", mode=mode, frames=F, size=f"{W}x{H}", focal_true=focal,
              focal_est=est, focal_rel_err=err, bound=bound, wall_s=round(wall, 3), **extra,
              launches=two_nn.launches, polish_launches=mode_polish,
              expected_polish_launches=polish_expected, points=int(m.point_valid().sum()),
              stage_s={s["stage"]: s["seconds"] for s in stages}, failures=failures)
        if failures:
            failed[mode] = failures
    if failed:
        raise AssertionError(f"modes failed: {failed}")
    return launches, polish


def general_problems(seed, batch, n_corr, device="cuda"):
    """tests/test_torch_solvers.py's exact general two-view problems."""
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp

    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(batch, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    R = np_so3_exp(axes * rng.uniform(0.05, 0.5, (batch, 1)))
    t = rng.normal(size=(batch, 3))
    t = 0.3 * t / np.linalg.norm(t, axis=-1, keepdims=True)
    K = np.zeros((batch, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -t[:, 2], t[:, 1], -t[:, 0]
    E = (K - np.swapaxes(K, 1, 2)) @ R
    u = np.concatenate([rng.normal(size=(batch, n_corr, 2)) * 0.5,
                        np.ones((batch, n_corr, 1))], -1)
    PX = np.einsum("bij,bnj->bni", R, u * rng.uniform(4, 8, (batch, n_corr, 1))) + t[:, None]
    v = np.concatenate([PX[..., :2] / PX[..., 2:], np.ones((batch, n_corr, 1))], -1)
    good = (PX[..., 2] > 0).all(-1)
    return (torch.as_tensor(u, device=device), torch.as_tensor(v, device=device),
            torch.as_tensor(E, device=device), good)


def run_solvers_phase(device="cuda"):
    """The solver bench on the card: (1) BENCH_r05's RANSAC workload, both
    engines; (2) the five-point "qr" solver at 512 × 8, scored as bench.py
    scores it, with "eig" beside it; (3) eig_real_batched against
    torch.linalg.eig on 2048 matrices; (4) 7- and 8-point exact recovery;
    (5) the solver-bench verb at its default 1000 trials; (6) the four
    comparison CSVs at the JAX defaults."""
    import contextlib
    import io

    from sphericalsfm_tpu_torch import cli
    from sphericalsfm_tpu_torch.eval import bench
    from sphericalsfm_tpu_torch.eval import experiments as ex
    from sphericalsfm_tpu_torch.eval.metrics import frobenius_error
    from sphericalsfm_tpu_torch.ops.linalg import eig_real_batched
    from sphericalsfm_tpu_torch.solvers.eight_point import solve_essential_8pt
    from sphericalsfm_tpu_torch.solvers.seven_point import solve_essential_7pt

    failures, info = [], {}
    # (1) RANSAC: the round bench's workload (64 pairs × 256 correspondences,
    # 2°, 1 px, 512 hypotheses) in float64, the drivers' dtype
    prob = bench.ransac_inputs(device, torch.float64)
    ransac = {}
    for name, run in bench.ransac_engines(prob).items():
        res, dt = bench.timed(lambda: run(torch.Generator(device=device).manual_seed(
            bench.RANSAC_SAMPLE_SEED)), device)
        err = bench.axis_angle_error_deg(res.r.cpu().numpy(), prob.R.cpu().numpy())
        ransac[name] = dict(median_rot_deg=float(np.median(err)), pairs_per_s=bench.PAIRS / dt,
                            seconds=dt, mean_inliers=float(res.num_inliers.double().mean()))
        if not ransac[name]["median_rot_deg"] < 0.02:
            failures.append(f"{name} RANSAC median {ransac[name]['median_rot_deg']} >= 0.02 deg")
    info["ransac"] = dict(workload=dict(pairs=bench.PAIRS, corr=bench.CORR,
                                        rotation_deg=bench.ROTATION_DEG,
                                        noise_px=bench.NOISE_PX, hypotheses=bench.HYPOTHESES),
                          **ransac)

    # (2) five-point: the round bench's 512 × 8 problems in float64,
    # Sampson-disambiguated with cheirality
    prob5 = bench.five_point_inputs(device, torch.float64)
    five = {}
    for method in ("qr", "eig"):
        err, dt, per_problem = bench.five_point_errors(prob5, method,
                                                       reps=3 if method == "qr" else 1)
        five[method] = dict(median_rot_deg=float(np.median(err)),
                            solves_per_s=bench.MINIMAL_BATCH / dt, seconds=dt,
                            valid_per_problem=per_problem)
    if not five["qr"]["median_rot_deg"] < 0.5:
        failures.append(f"five-point qr median {five['qr']['median_rot_deg']} >= 0.5 deg")
    info["five_point"] = five

    # (3) eig_real_batched against torch.linalg.eig on 2048 10×10 matrices
    Ms = torch.as_tensor(np.random.default_rng(7).normal(size=(2048, 10, 10)), device=device)
    (lam, _, valid), dt_q = bench.timed(lambda: eig_real_batched(Ms), device)
    (w, _), dt_e = bench.timed(lambda: torch.linalg.eig(Ms), device, reps=1)
    # its parts: without the 60 Aberth iterations, and the polish's 11×11
    # QR as geqrf (what it runs) against torch.linalg.qr forming Q
    _, dt_no_aberth = bench.timed(lambda: eig_real_batched(Ms, aberth_iters=0), device)
    J = torch.as_tensor(np.random.default_rng(8).normal(size=(20480, 11, 11)), device=device)
    _, dt_geqrf = bench.timed(lambda: torch.geqrf(J), device)
    _, dt_qr = bench.timed(lambda: torch.linalg.qr(J), device, reps=1)

    def chained(x, n=1500):           # eager launch cost: one small op after another
        for _ in range(n):
            x = x * 1.0000001
        return x

    _, dt_chain = bench.timed(lambda: chained(Ms[:, 0]), device)
    w, lam, valid = w.cpu().numpy(), lam.cpu().numpy(), valid.cpu().numpy()
    found = total = false_pos = 0
    for i in range(len(w)):
        wr = w[i][np.abs(w[i].imag) < 1e-9].real
        got = lam[i][valid[i]]
        total += len(wr)
        found += sum(bool(len(got)) and bool(np.abs(got - x).min() < 1e-8 * max(1.0, abs(x)))
                     for x in wr)
        false_pos += sum(bool(np.abs(w[i] - x).min() >= 1e-7 * (1 + abs(x))) for x in got)
    info["eig"] = dict(matrices=len(w), eig_real_batched_ms=1e3 * dt_q, linalg_eig_ms=1e3 * dt_e,
                       without_aberth_ms=1e3 * dt_no_aberth,
                       polish_qr_20480x11x11=dict(geqrf_ms=1e3 * dt_geqrf,
                                                  linalg_qr_ms=1e3 * dt_qr),
                       eager_launch_us=1e6 * dt_chain / 1500,
                       real_eigenvalues=total, found=found, false_positives=false_pos)
    # a near-real complex pair (0.2022 ± 0.0023i in matrix 542) can pass the
    # JAX algorithm's residual test as one real eigenvalue: counted, not gated
    if found != total:
        failures.append(f"eig_real_batched found {found} of {total} real eigenvalues")

    # (4) 7- and 8-point exact recovery on the card
    exact = {}
    for name, n, solve in (("sevenpt", 7, solve_essential_7pt),
                           ("normalized_8pt", 16, solve_essential_8pt)):
        u, v, E, good = general_problems(9 if n == 7 else 6, 64, n, device)
        Es, valid = solve(u, v)
        if Es.dim() == 3:
            Es, valid = Es[:, None], valid[:, None]
        err = torch.where(valid, frobenius_error(Es, E[:, None]),
                          torch.full(valid.shape, math.inf, dtype=E.dtype, device=device))
        exact[name] = float(np.median(err.min(-1).values.cpu().numpy()[good]))
    info["exact_recovery_median_frob"] = exact
    if not exact["sevenpt"] < 1e-6 or not exact["normalized_8pt"] < 1e-8:
        failures.append(f"exact recovery {exact}")

    # (5) the solver-bench verb at its defaults
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["solver-bench"])
    rows = json.loads(buf.getvalue())
    info["solver_bench"] = dict(seconds=time.perf_counter() - t0, rows=rows)
    if not rows[0]["median_frob"] < 1e-10:
        failures.append(f"solver-bench zero-noise median {rows[0]['median_frob']}")

    # (6) the four comparison CSVs at the JAX defaults (no figures: the card's
    # machine has no matplotlib)
    comps = {}
    with tempfile.TemporaryDirectory() as d:
        for name, fn in (("relpose", lambda p: ex.relpose_comparison(p, device=device)),
                         ("noise", lambda p: ex.noise_comparison(p, device=device)[0]),
                         ("stability", lambda p: ex.stability_comparison(p, device=device)[0]),
                         ("ransac", lambda p: ex.ransac_comparison(p, device=device)[0])):
            path = os.path.join(d, f"{name}.csv")
            t0 = time.perf_counter()
            rows = fn(path)
            comps[name] = dict(seconds=round(time.perf_counter() - t0, 3), rows=len(rows),
                               written=os.path.getsize(path) > 0)
            if name in ("stability", "ransac"):
                comps[name]["values"] = rows
        info["comparisons"] = comps
    if not all(c["written"] and c["rows"] for c in comps.values()):
        failures.append(f"comparison CSVs {comps}")
    phase("solvers", **info, failures=failures)
    if failures:
        raise AssertionError(f"solvers failed: {failures}")


BENCH_ROWS = ("ba", "six_point", "detection", "matcher")


def run_bench_phase(two_nn, device="cuda"):
    """The round bench's rows that no other phase holds
    (sphericalsfm_tpu_torch/eval/bench.py, the rows of bench_torch.py): BA on
    the 64-camera bench scene, the shared-focal six-point solver, detection
    ms per frame and the matcher at K = 4096. One line per row with its
    gates beside JAX's values; any gate missed fails the phase. Returns the
    phase's bf16 and float32 matcher launches."""
    from sphericalsfm_tpu_torch.eval import bench

    reset_counts(two_nn)
    rows = {}
    for name in BENCH_ROWS:
        t0 = time.perf_counter()
        rows[name] = bench.ROWS[name](device)
        phase("bench", row=name, seconds=round(time.perf_counter() - t0, 3), **rows[name],
              gates=bench.row_gates(name, rows[name]))
    failures = bench.gate_failures(rows)
    routes = dict(two_nn.route_launches)
    if not routes["wgmma_bf16"] or not routes["fma_f32"]:
        failures.append(f"matcher row launched {routes}, expected both kernels")
    if failures:
        raise AssertionError(f"bench failed: {failures}")
    return routes["wgmma_bf16"], routes["fma_f32"]


def shifted_pair(h: int, w: int, seed: int = 1):
    """tests/test_panorama.py's flow case: a smooth random field and a copy
    shifted by 3 px in x (u ≈ +3)."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(rng.random((h + 8, w + 8)).astype(np.float32), 2.0)
    base = ((base - base.min()) / (base.max() - base.min())).astype(np.float32)
    return base[4:4 + h, 4:4 + w], base[4:4 + h, 1:1 + w]


def write_poses(path, cam_r, cam_t):
    with open(path, "w") as f:
        for i in range(len(cam_r)):
            vals = list(cam_t[i]) + list(cam_r[i])
            f.write(f"{i} " + " ".join(f"{v:.15f}" for v in vals) + " \n")


def render_config5(device="cuda", F=32, W=640, H=480):
    """BASELINE.md config (5), as scripts/bench_panorama.py renders it."""
    from sphericalsfm_tpu_torch.eval.render import render_capture

    focal = 0.8 * W
    cam_r, cam_t, _, color = render_capture(num_frames=F, focal=focal, width=W, height=H,
                                            wave_freq=25.0 * (W / 320), device=device)
    return cam_r, cam_t, color, (focal, W / 2.0, H / 2.0)


def first_pair(poses_path, color, pano_width, nphi):
    """The stitcher's first keyframe pair of a capture: its gray frames
    (float32, as the stitcher makes them), poses and assigned columns."""
    from sphericalsfm_tpu_torch.io.nerf import read_poses
    from sphericalsfm_tpu_torch.pipeline import stereo_panorama as sp

    idx, ts, rs = read_poses(poses_path)
    idx, rs, ts = sp.normalize_trajectory(idx, rs, ts)
    kf = sp.order_keyframes(sp.PanoKeyframes(idx, rs, ts, sp.compute_thetas(rs, ts)), True)
    assignments, _, _ = sp.assign_columns(kf, pano_width, nphi)
    left, right = min(assignments)
    imgs = color[[kf.index[left], kf.index[right]]]
    gray = (imgs.astype(np.float64).mean(-1) / 255.0).astype(np.float32)
    poses = [(kf.r[k].astype(np.float32), kf.t[k].astype(np.float32)) for k in (left, right)]
    return gray, imgs, poses, assignments[(left, right)]


def run_flow_phase(pair_gray, device="cuda", W=640, H=480, levels=4, iters=60):
    """Shift recovery at full size, and one keyframe pair's two flows on the
    card against the CPU. Returns the flows {device: (u, v)} (2, H, W)."""
    from sphericalsfm_tpu_torch.ops.optical_flow import horn_schunck_flow

    I0, I1 = shifted_pair(H, W)
    t0 = time.perf_counter()
    u, v = horn_schunck_flow(torch.from_numpy(I0).to(device), torch.from_numpy(I1).to(device),
                             num_levels=levels, iters_per_level=iters)
    sync(device)
    shift_s = time.perf_counter() - t0
    med_u = float(u[20:-20, 20:-20].median())
    med_v = float(v[20:-20, 20:-20].median())

    flows, secs = {}, {}
    for dev in (device, "cpu"):
        g = torch.from_numpy(pair_gray).to(dev)
        t0 = time.perf_counter()
        fu, fv = horn_schunck_flow(torch.stack([g[0], g[1]]), torch.stack([g[1], g[0]]),
                                   num_levels=levels, iters_per_level=iters)
        sync(dev)
        secs[dev] = round(time.perf_counter() - t0, 3)
        flows[dev] = (fu.cpu(), fv.cpu())
    d = torch.cat([(flows[device][0] - flows["cpu"][0]).abs().flatten(),
                   (flows[device][1] - flows["cpu"][1]).abs().flatten()])
    p99 = float(torch.quantile(d.double(), 0.99))
    info = dict(size=f"{W}x{H}", levels=levels, iters=iters, shift_median_u=med_u,
                shift_median_v=med_v, shift_s=round(shift_s, 3), pair_max_abs_diff=float(d.max()),
                pair_p99_abs_diff=p99, pair_s=secs)
    phase("flow", **info)
    if not abs(med_u - 3.0) < 0.35 or not abs(med_v) < 0.3:
        raise AssertionError(f"flow shift not recovered: median u {med_u}, v {med_v}")
    if not p99 < 1e-3:
        raise AssertionError(f"CUDA and CPU flows differ: 99th percentile {p99} px")
    return flows


def pair_columns_check(pair, flows, intrinsics, device="cuda"):
    """One keyframe pair's synthesized columns, on the card and on the CPU,
    each from its own flows: PSNR over the valid columns, equal masks."""
    from sphericalsfm_tpu_torch.pipeline.stereo_panorama import synthesize_pair_columns

    _, imgs, poses, (_, _, th, ph, alpha) = pair
    out = {}
    for dev in (device, "cpu"):
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        u, v = (x.to(dev) for x in flows[dev])
        cols, valid = synthesize_pair_columns(
            *(f32(x) for x in intrinsics), f32(th), f32(ph), f32(alpha),
            tuple(f32(x) for x in poses[0]), tuple(f32(x) for x in poses[1]),
            f32(imgs[0]), f32(imgs[1]), torch.stack([u[0], v[0]], -1),
            torch.stack([u[1], v[1]], -1))
        out[dev] = (torch.clamp(cols, 0, 255).cpu().double(), valid.cpu())
    (a, va), (b, vb) = out[device], out["cpu"]
    mse = float(((a[va] - b[va]) ** 2).mean()) if bool(va.any()) else 0.0
    psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    return dict(columns=int(len(va)), valid=int(va.sum()), same_valid=bool(torch.equal(va, vb)),
                psnr_db=psnr, max_abs_diff=float((a - b).abs().max()))


def stitch(poses_path, color, intrinsics, out, pano_width, nphi, device="cuda"):
    """One make_stereo_panoramas call: wall, stages, fill fractions, files."""
    from sphericalsfm_tpu_torch.pipeline.stereo_panorama import make_stereo_panoramas

    stats = {}
    t0 = time.perf_counter()
    sph = make_stereo_panoramas(poses_path, color, intrinsics, out, pano_width=pano_width,
                                nphi=nphi, device=device, stats=stats)
    sync(device)
    wall = time.perf_counter() - t0
    files = ([f"cylindrical{p}.png" for p in range(nphi)]
             + [f"spherical{p}.png" for p in range(nphi)]
             + [f"overunder{nphi - p - 1}{p}.png" for p in range(nphi // 2)])
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    fill = [float(np.mean(read_png(os.path.join(out, f"cylindrical{p}.png")).sum(axis=(0, 2)) > 0))
            for p in range(nphi) if f"cylindrical{p}.png" not in missing]
    secs = stats["seconds"]
    return dict(wall_s=round(wall, 3), stage_s={k: round(v, 3) for k, v in secs.items()},
                flows_share=secs.get("flows", 0.0) / wall, keyframes=stats["keyframes"],
                pairs=stats["pairs"], columns=stats["columns"], min_fill=min(fill or [0.0]),
                fill=[round(f, 4) for f in fill], spherical_shape=list(sph[0].shape),
                missing=missing)


def read_png(path):
    """Decode an 8-bit RGB PNG of io/png.py (filter type 0 rows, the only
    kind it writes)."""
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


PANO_SIZES = dict(F=32, W=640, H=480, pano_width=2048, nphi=5,  # config (5)
                  cli_width=2048, cli_nphi=9)                   # the CLI defaults


def config5_case(tmp, device="cuda", sizes=PANO_SIZES):
    """Config (5)'s render, its ground-truth poses.txt and its first pair."""
    cam_r, cam_t, color, intr = render_config5(device, sizes["F"], sizes["W"], sizes["H"])
    poses = os.path.join(tmp, "config5_poses.txt")
    write_poses(poses, cam_r, cam_t)
    return dict(poses=poses, color=color, intrinsics=intr,
                pair=first_pair(poses, color, sizes["pano_width"], sizes["nphi"]))


def run_panorama_phase(case5, flows, workflow, tmp, device="cuda", sizes=PANO_SIZES):
    """(a) config (5) cold and warm, with the pair check on its first pair;
    (b) the calibrated run's poses and frames at the CLI defaults. Returns
    (b)'s poses path."""
    failures = []
    runs = {run: stitch(case5["poses"], case5["color"], case5["intrinsics"],
                        os.path.join(tmp, f"config5_{run}"), sizes["pano_width"], sizes["nphi"],
                        device)
            for run in ("cold", "warm")}
    check = pair_columns_check(case5["pair"], flows, case5["intrinsics"], device)
    phase("panorama", case="config5", frames=sizes["F"], size=f"{sizes['W']}x{sizes['H']}",
          pano_width=sizes["pano_width"], nphi=sizes["nphi"], **runs, pair_check=check)
    for run, r in runs.items():
        if r["missing"] or not r["min_fill"] > 0.8:
            failures.append(f"config5 {run}: missing {r['missing']}, fill {r['fill']}")
    if not check["same_valid"] or not check["psnr_db"] >= 40.0:
        failures.append(f"pair columns CUDA vs CPU: {check}")

    poses_b = os.path.join(tmp, "calibrated_poses.txt")
    with open(poses_b, "w") as f:
        f.write(workflow["poses_txt"])
    r = stitch(poses_b, workflow["color"], workflow["intrinsics"], os.path.join(tmp, "workflow"),
               sizes["cli_width"], sizes["cli_nphi"], device)
    phase("panorama", case="calibrated_workflow", frames=len(workflow["color"]),
          pano_width=sizes["cli_width"], nphi=sizes["cli_nphi"],
          poses_from=f"main phase ({workflow['launches']} matcher launches)", **r)
    if r["missing"] or not r["min_fill"] > 0.8:
        failures.append(f"workflow: missing {r['missing']}, fill {r['fill']}")
    if failures:
        raise AssertionError(f"panorama failed: {failures}")
    return poses_b


def run_circle_views_phase(poses_path, workflow, out, device="cuda", num_views=64):
    from sphericalsfm_tpu_torch.pipeline.stereo_panorama import make_circle_views

    stats = {}
    t0 = time.perf_counter()
    n = make_circle_views(poses_path, workflow["color"], workflow["intrinsics"], out,
                          num_views=num_views, device=device, stats=stats)
    sync(device)
    wall = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    nonzero = [float(np.mean(read_png(os.path.join(out, f)).sum(-1) > 0)) for f in names]
    phase("circle_views", views=num_views, written=n, files=len(names), wall_s=round(wall, 3),
          stage_s={k: round(v, 3) for k, v in stats["seconds"].items()}, pairs=stats["pairs"],
          min_nonzero=min(nonzero or [0.0]))
    if not n >= 0.75 * num_views or len(names) != n or not min(nonzero or [0.0]) > 0.5:
        raise AssertionError(f"circle views: {n} of {num_views} written, {len(names)} files, "
                             f"least non-zero share {min(nonzero or [0.0])}")


BA_ITERS = 15   # the round bench times 10 (eval/bench.py BA_SCALE_ITERS)


def rms_px(cost, K):
    """RMS residual per observation coordinate, from the robust cost (as
    scripts/bench_ba_scale.py reports it)."""
    return math.sqrt(2.0 * cost / max(K, 1) / 2.0)


def timed_ba(ba, prob, device, **kw):
    """One bundle_adjust call: result, wall seconds and peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    res = ba.bundle_adjust(prob, **kw)
    sync(device)
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def ba_summary(res, K, wall, peak, warm=None):
    out = dict(iterations=res.iterations, pcg_iterations=res.pcg_iterations,
               initial_cost=float(res.initial_cost), final_cost=float(res.cost),
               rms_px=rms_px(float(res.cost), K), wall_s=round(wall, 3),
               lm_iters_per_s=res.iterations / wall, peak_gib=round(peak / 2**30, 3))
    if warm is not None:
        res_w, wall_w = warm
        out.update(warm_wall_s=round(wall_w, 3), warm_lm_iters_per_s=res_w.iterations / wall_w,
                   warm_final_cost=float(res_w.cost))
    return out


def matvec_bound(prob, K, sd_bytes=4):
    """Least time of one PCG matvec on an H100: the bytes it must move —
    per observation a 6×3 U block, the gathered 6-vector and 3-vector and
    two indices; per point a 3×3 Hpp⁻¹ block and its 3-vector; the camera
    vectors in and out — over the memory rate. Returns (ms, bytes)."""
    C, P = prob.cam_t.shape[0], prob.points.shape[0]
    nbytes = K * ((18 + 6 + 3) * sd_bytes + 2 * 8) + P * 12 * sd_bytes + 2 * C * 6 * sd_bytes
    return 1e3 * nbytes / H100_HBM_BYTES, nbytes


def run_ba_scale_phase(device="cuda", sizes=None):
    """The JAX package's large-scale BA (scripts/bench_ba_scale.py) at full
    width: (a) "auto" with the bench's float32 PCG settings, cold and warm;
    (b) the exact dense solve, the problem upcast to float64; (c) (a) with
    the coarse level;
    (d) the checkpointed run stopped after one 5-iteration segment and
    resumed, against an uninterrupted segmented run. Then CUDA-event times
    of one assembly, one matvec and one preconditioner apply. The scene's
    sizes and the PCG settings are the round bench's (eval/bench.py)."""
    from sphericalsfm_tpu_torch.eval import bench
    from sphericalsfm_tpu_torch.eval.synthetic import make_ring_scene
    from sphericalsfm_tpu_torch.optim import ba

    sizes = sizes or bench.BA_SCALE
    solve = bench.BA_SCALE_SOLVE
    t0 = time.perf_counter()
    p = make_ring_scene(**sizes, device=device)
    scene_s = time.perf_counter() - t0
    K = int((p.obs_w > 0).sum())
    t0 = time.perf_counter()
    prep, solver = ba.prepare_problem(p, "auto")
    prep_s = time.perf_counter() - t0
    pairs = ba.count_cc_pairs(prep)

    ba.bundle_adjust.solves.update(dense=0, pcg=0)
    res_a, cold_a, peak_a = timed_ba(ba, p, device, camera_solver="auto", max_iters=BA_ITERS,
                                     **solve)
    auto_solves = dict(ba.bundle_adjust.solves)
    res_aw, warm_a, _ = timed_ba(ba, p, device, camera_solver="auto", max_iters=BA_ITERS,
                                 **solve)
    res_c, wall_c, peak_c = timed_ba(ba, p, device, camera_solver="auto", max_iters=BA_ITERS,
                                     pcg_coarse=16, **solve)
    # the exact reference: the same problem upcast, assembled and solved in
    # float64 (a float32 assembly stalls the exact solve at small λ)
    p64 = p._replace(**{k: getattr(p, k).double() for k in (
        "focal", "cam_t", "cam_r", "points", "obs_uv", "obs_w")})
    res_b, wall_b, peak_b = timed_ba(ba, p64, device, camera_solver="dense",
                                     max_iters=BA_ITERS, solve_dtype_name="float64", ftol=1e-12)
    del p64
    with tempfile.TemporaryDirectory() as d:
        kw = dict(camera_solver="auto", segment=5, **solve)
        full = ba.bundle_adjust_checkpointed(p, os.path.join(d, "full.npz"), max_iters=BA_ITERS,
                                             **kw)
        part = ba.bundle_adjust_checkpointed(p, os.path.join(d, "ck.npz"), max_iters=5, **kw)
        resumed = ba.bundle_adjust_checkpointed(p, os.path.join(d, "ck.npz"),
                                                max_iters=BA_ITERS, **kw)
    ck_rel = abs(float(resumed.cost) - float(full.cost)) / float(full.cost)

    lam = torch.full((), 1e-4, dtype=torch.float32, device=device)
    state = (prep.focal, prep.cam_t, prep.cam_r, prep.points, prep, lam, 1.0, torch.float32)
    assembly_ms = bench.device_ms(lambda: ba._assemble_reduced(*state), device, reps=5, warmup=1)
    rs = ba._assemble_reduced(*state)
    op = ba._pcg_operator(rs, lam, torch.float32)
    op_c = ba._pcg_operator(rs, lam, torch.float32, ba._coarse_tables(prep, 16))
    gen = torch.Generator(device=device).manual_seed(0)
    vc = torch.randn(rs.free_c.shape, generator=gen, device=device) * rs.free_c
    vf = torch.zeros((), device=device)
    matvec_ms = bench.device_ms(lambda: op.matvec(vc, vf), device, reps=50)
    precond_ms = bench.device_ms(lambda: op.precond(vc, vf), device, reps=50)
    coarse_precond_ms = bench.device_ms(lambda: op_c.precond(vc, vf), device, reps=50)
    bound_ms, nbytes = matvec_bound(prep, K)
    del rs, op, op_c

    info = dict(cameras=sizes["C"], points=sizes["P"], obs_per_camera=sizes["W"],
                live_observations=K, same_point_pairs=pairs, scene_s=round(scene_s, 3),
                prepare_s=round(prep_s, 3), auto_resolved=solver, auto_solves=auto_solves,
                pcg=ba_summary(res_a, K, cold_a, peak_a, warm=(res_aw, warm_a)),
                dense_f64=ba_summary(res_b, K, wall_b, peak_b),
                pcg_coarse16=ba_summary(res_c, K, wall_c, peak_c),
                checkpoint=dict(full_cost=float(full.cost), resumed_cost=float(resumed.cost),
                                rel_diff=ck_rel, first_segment_iterations=part.iterations,
                                iterations=[full.iterations, resumed.iterations]),
                assembly_ms=assembly_ms, matvec_ms=matvec_ms, precond_ms=precond_ms,
                coarse_precond_ms=coarse_precond_ms, matvec_bound_ms=bound_ms,
                matvec_bytes=nbytes, matvec_share_of_bound=bound_ms / matvec_ms)
    phase("ba_scale", **info)
    failures = []
    if solver != "pcg" or auto_solves != {"dense": 0, "pcg": 1}:
        failures.append(f"auto resolved to {solver}, solves {auto_solves}")
    for name, res in (("pcg", res_a), ("pcg warm", res_aw), ("pcg_coarse16", res_c)):
        if not float(res.cost) < 0.5 * float(res.initial_cost):
            failures.append(f"{name}: cost {float(res.cost)} not < 0.5 x initial")
        if not float(res.cost) <= 1.3 * float(res_b.cost):
            failures.append(f"{name}: cost {float(res.cost)} > 1.3 x dense {float(res_b.cost)}")
    if not ck_rel <= 1e-6:
        failures.append(f"checkpoint resume off by {ck_rel} relative cost")
    if failures:
        raise AssertionError(f"ba_scale failed: {failures}")


MESH_SHARDS = 4   # logical shards on one card: Mesh((cuda:0,) * 4)


def equal_tables(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def run_mesh_phase(two_nn, reference, gray, color, device="cuda", shards=MESH_SHARDS,
                   ba_sizes=None):
    """The sharded stages on a mesh of `shards` logical shards of one card,
    each beside the single-device run on the same card (times labelled
    "logical shards on one card": not a multi-GPU speed): detection and
    matching bit for bit, pairwise RANSAC within the JAX test's bounds,
    retriangulation and BA of the main phase's capture, the ring matcher on
    the float32 kernel against match_pairs_compact and the kernel's plain
    version, and the ba_scale scene through distributed_bundle_adjust.
    Returns the bf16 launches of the sharded matching, the f32 launches of
    the ring and the polish launches of the sharded pairwise RANSAC."""
    import copy

    from sphericalsfm_tpu_torch.device import generator
    from sphericalsfm_tpu_torch.eval import bench
    from sphericalsfm_tpu_torch.eval.synthetic import make_ring_scene
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.ops.matching import match_pairs_compact
    from sphericalsfm_tpu_torch.optim import ba
    from sphericalsfm_tpu_torch.optim.pose_graph import (
        RotationGraph, initialize_rotations_global, optimize_rotations,
    )
    from sphericalsfm_tpu_torch.parallel import Mesh, distributed_bundle_adjust, ring_match_pairs
    from sphericalsfm_tpu_torch.parallel.ring_matching import _block_two_nn
    from sphericalsfm_tpu_torch.pipeline import driver
    from sphericalsfm_tpu_torch.pipeline.frontend import detect_features, match_pairs
    from sphericalsfm_tpu_torch.pipeline.pairwise import all_pairs, estimate_pairwise
    from sphericalsfm_tpu_torch.pipeline.sfm import SfMMap
    from sphericalsfm_tpu_torch.pipeline.tracks import (
        build_feature_tracks, filter_triplet_cycles,
    )

    def timed_once(fn, dev):          # one synchronized call
        return bench.timed(fn, dev, reps=1, warmup=0)

    dev = torch.device(device)
    mesh = Mesh([dev] * shards)
    cfg = main_config()
    F, H, W = gray.shape
    focal = 0.8 * W
    out, secs, failures = {"shards": shards, "label": "logical shards on one card"}, {}, []

    feats0, secs["detect_single_s"] = timed_once(
        lambda: detect_features(gray, color, cfg.frontend, device=dev), dev)
    feats1, secs["detect_mesh_s"] = timed_once(
        lambda: detect_features(gray, color, cfg.frontend, mesh=mesh), dev)
    out["detect_bit_equal"] = bool(
        all(np.array_equal(getattr(feats0, k), getattr(feats1, k))
            for k in ("xy", "descriptor", "valid", "color"))
        and torch.equal(feats0.descriptor_dev, feats1.descriptor_dev))

    pi, pj = all_pairs(F)
    reset_counts(two_nn)
    m0, secs["match_single_s"] = timed_once(
        lambda: match_pairs(feats0, pi, pj, cfg.frontend, device=dev), dev)
    single_launches = two_nn.launches
    reset_counts(two_nn)
    m1, secs["match_mesh_s"] = timed_once(lambda: match_pairs(feats0, pi, pj, cfg.frontend,
                                                              mesh=mesh), dev)
    mesh_launches, mesh_routes = two_nn.launches, dict(two_nn.route_launches)
    chunks = math.ceil(len(pi) / CHUNK)
    expected = sum(min(shards, len(pi) - s) for s in range(0, len(pi), CHUNK))
    out.update(match_equal=equal_tables(m0, m1), single_launches=single_launches,
               mesh_launches=mesh_launches, mesh_route_launches=mesh_routes,
               expected_mesh_launches=expected)

    intr = Intrinsics(focal, W / 2.0, H / 2.0)
    pw_kw = dict(inlier_threshold_px=cfg.ransac.inlier_threshold_px,
                 min_num_inliers=cfg.ransac.min_num_inliers,
                 num_hypotheses=cfg.ransac.num_hypotheses, chunk_size=cfg.ransac.pair_chunk,
                 round_size=cfg.ransac.round_size, confidence=cfg.ransac.confidence)
    reset_counts(two_nn)
    pw0, secs["pairwise_single_s"] = timed_once(lambda: estimate_pairwise(
        generator(dev, 0), feats0.xy, pi, pj, *m0, intr, device=dev, **pw_kw), dev)
    single_polish = polish_launches()
    reset_counts(two_nn)
    pw1, secs["pairwise_mesh_s"] = timed_once(lambda: estimate_pairwise(
        generator(dev, 0), feats0.xy, pi, pj, *m0, intr, mesh=mesh, **pw_kw), dev)
    mesh_polish = polish_launches()
    polish_expected = (polish_parts(len(pi), cfg.ransac.pair_chunk),
                       polish_parts(len(pi), cfg.ransac.pair_chunk, shards))
    out.update(single_polish_launches=single_polish, mesh_polish_launches=mesh_polish,
               expected_polish_launches=polish_expected)
    rot_diff = np.rad2deg(np.linalg.norm(pw0.r - pw1.r, axis=-1))
    out.update(pairwise_keep_equal=bool((pw0.keep == pw1.keep).all()),
               pairwise_max_inlier_diff=int(np.abs(pw0.num_inliers - pw1.num_inliers).max()),
               pairwise_max_rot_diff_deg=float(rot_diff[pw0.keep].max()),
               pairwise_bit_equal=bool(np.array_equal(pw0.r, pw1.r)
                                       and np.array_equal(pw0.inlier_mask, pw1.inlier_mask)))

    # the calibrated driver's middle on the single-device pairwise: rotation
    # averaging, tracks, then retriangulation and BA on one device and on the mesh
    fr = driver.FrontendResult(feats0, pi, pj, *m0)
    keep = driver._graph_from_pairwise(fr, pw0, pw0.keep, cfg.graph.min_rotation_deg)
    keep = filter_triplet_cycles(pi, pj, pw0.r, keep, cfg.graph.triplet_filter_deg)
    g = RotationGraph(torch.as_tensor(pi.astype(np.int64), device=dev),
                      torch.as_tensor(pj.astype(np.int64), device=dev),
                      torch.as_tensor(pw0.r, device=dev),
                      torch.as_tensor(keep.astype(float), device=dev))
    rots, _ = optimize_rotations(initialize_rotations_global(
        F, g, weights=np.where(keep, pw0.num_inliers, 0)), g)
    tracks = build_feature_tracks(F, feats0.counts, pi, pj, *m0[:2],
                                  pw0.inlier_mask & m0[2] & keep[:, None])
    base = SfMMap.build(intr, rots.cpu().numpy(), tracks, feats0.xy, colors=feats0.color,
                        device=dev)
    maps = [copy.deepcopy(base) for _ in range(3)]
    _, secs["retriangulate_single_s"] = timed_once(
        lambda: maps[0].retriangulate(generator(dev, 1)), dev)
    _, secs["retriangulate_mesh_s"] = timed_once(
        lambda: maps[1].retriangulate(generator(dev, 1), mesh=mesh), dev)
    ok0, ok1 = maps[0].point_valid(), maps[1].point_valid()
    out.update(points=int(ok0.sum()), retriangulate_ok_equal=bool(np.array_equal(ok0, ok1)),
               retriangulate_max_diff=float(np.abs(maps[0].points - maps[1].points).max()),
               retriangulate_bit_equal=bool(np.array_equal(maps[0].points, maps[1].points)))
    for mp in maps[1:]:
        mp.points = maps[0].points.copy()
    ba_kw = dict(max_iters=cfg.ba.max_iters, solve_dtype=cfg.ba.solve_dtype,
                 loss_scale=cfg.ba.loss_scale, pcg_rtol=cfg.ba.pcg_rtol,
                 pcg_iters=cfg.ba.pcg_iters)
    st0, secs["optimize_single_s"] = timed_once(lambda: maps[0].optimize(**ba_kw), dev)
    st1, secs["optimize_mesh_s"] = timed_once(lambda: maps[1].optimize(**ba_kw, mesh=mesh), dev)
    st2 = maps[2].optimize(**ba_kw, mesh=mesh)
    opt_rel = abs(st1["final_cost"] - st0["final_cost"]) / st0["final_cost"]
    out.update(optimize=dict(single=st0, mesh=st1, rel_cost_diff=opt_rel),
               optimize_repeat_bit_equal=bool(
                   np.array_equal(maps[1].cam_r, maps[2].cam_r)
                   and np.array_equal(maps[1].points, maps[2].points)
                   and st1["final_cost"] == st2["final_cost"]))

    # the ring matcher on the float32 kernel, against the port's float32
    # matcher (the same kernel, pair by pair) and one step against the
    # kernel's plain version
    desc32, valid = feats0.descriptor_dev.float(), feats0.valid_dev
    M = cfg.frontend.max_matches_per_pair
    reset_counts(two_nn)
    ring, secs["ring_mesh_s"] = timed_once(lambda: ring_match_pairs(mesh, desc32, valid, M), dev)
    ring_launches = two_nn.route_launches["fma_f32"]
    ring_total = two_nn.launches
    ref, secs["match_f32_single_s"] = timed_once(lambda: match_pairs_compact(
        desc32, valid, torch.as_tensor(pi, device=dev), torch.as_tensor(pj, device=dev), M,
        compute_dtype=torch.float32), dev)
    ring_equal = (np.array_equal(ring[0], pi) and equal_tables(ring[2:], [
        x.cpu().numpy() for x in ref]))
    Bf = F // shards
    m1s, m2s, nns = _block_two_nn(desc32[Bf:2 * Bf], desc32[:Bf], valid[Bf:2 * Bf], valid[:Bf])
    b_i = torch.arange(Bf, device=dev).repeat(Bf)
    b_j = Bf + torch.arange(Bf, device=dev).repeat_interleave(Bf)
    plain = reference(torch.cat([desc32[:Bf], desc32[Bf:2 * Bf]]),
                      torch.cat([valid[:Bf], valid[Bf:2 * Bf]]), b_i, b_j, torch.float32)
    ring_check = bench.plain_check((m1s.reshape(Bf * Bf, -1), m2s.reshape(Bf * Bf, -1),
                                    nns.reshape(Bf * Bf, -1)), plain, valid[b_j.long()],
                                   torch.float32)
    if not ring_check["ok"]:
        raise AssertionError(f"ring step f32 != plain version: {ring_check}")
    ring_err = ring_check["max_abs_err"]
    out.update(ring_equal=ring_equal, ring_launches=ring_launches,
               ring_expected_launches=shards * shards, ring_step_max_abs_err=ring_err,
               ring_matches=int(ring[4].sum()))

    # ba_scale through distributed_bundle_adjust on the mesh, beside the
    # single-device PCG run in this process
    p = make_ring_scene(**(ba_sizes or bench.BA_SCALE), device=device)
    kw = dict(camera_solver="auto", max_iters=BA_ITERS, **bench.BA_SCALE_SOLVE)
    ba.bundle_adjust(p, **kw)                       # warm the single-device path
    r_single, secs["ba_scale_single_s"] = timed_once(lambda: ba.bundle_adjust(p, **kw), dev)
    r_a, secs["ba_scale_mesh_cold_s"] = timed_once(
        lambda: distributed_bundle_adjust(mesh, p, **kw), dev)
    r_b, secs["ba_scale_mesh_s"] = timed_once(
        lambda: distributed_bundle_adjust(mesh, p, **kw), dev)
    ba_rel = abs(float(r_a.cost) - float(r_single.cost)) / float(r_single.cost)
    out.update(ba_scale=dict(
        initial_cost=float(r_single.initial_cost), single_cost=float(r_single.cost),
        mesh_cost=float(r_a.cost), rel_cost_diff=ba_rel, single_iterations=r_single.iterations,
        mesh_iterations=r_a.iterations, single_pcg_iterations=r_single.pcg_iterations,
        mesh_pcg_iterations=r_a.pcg_iterations,
        repeat_bit_equal=bool(torch.equal(r_a.cam_r, r_b.cam_r)
                              and torch.equal(r_a.points, r_b.points)
                              and float(r_a.cost) == float(r_b.cost))))
    del p

    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    out["visible_cards"] = visible
    out["driver_on_mesh"] = "needs ≥ 2 cards"
    phase("mesh", **out, seconds=secs)

    if not out["detect_bit_equal"]:
        failures.append("sharded detection differs from one device")
    if not out["match_equal"]:
        failures.append("sharded matching differs from one device")
    if mesh_launches != expected or mesh_routes["wgmma_bf16"] != expected:
        failures.append(f"sharded matching launched {mesh_routes}, expected {expected} bf16")
    if single_launches != chunks:
        failures.append(f"single-device matching launched {single_launches}, expected {chunks}")
    if (single_polish, mesh_polish) != polish_expected:
        failures.append(f"polish launched {single_polish} (single) and {mesh_polish} (mesh) "
                        f"times, expected {polish_expected}")
    if not (out["pairwise_keep_equal"] and out["pairwise_max_inlier_diff"] <= 3
            and out["pairwise_max_rot_diff_deg"] < 0.1):
        failures.append("sharded pairwise outside the JAX test's bounds")
    if not (out["retriangulate_ok_equal"] and out["retriangulate_max_diff"] <= 1e-5):
        failures.append("sharded retriangulation differs from one device")
    if not (opt_rel <= 1e-6 and out["optimize_repeat_bit_equal"]):
        failures.append(f"sharded SfMMap.optimize: rel cost diff {opt_rel}, repeat "
                        f"{out['optimize_repeat_bit_equal']}")
    if not ring_equal:
        failures.append("ring differs from the float32 matcher")
    if ring_launches != shards * shards or ring_total != ring_launches:
        failures.append(f"ring launched {ring_launches} f32 of {ring_total}, expected "
                        f"{shards * shards}")
    bs = out["ba_scale"]
    if not (ba_rel <= 1e-3 and bs["mesh_cost"] < 0.5 * bs["initial_cost"]
            and bs["repeat_bit_equal"]):
        failures.append(f"distributed ba_scale: {bs}")
    if failures:
        raise AssertionError(f"mesh failed: {failures}")
    if visible >= 2:
        n = 2 if visible < 4 else 4
        run_main_path(two_nn, device=device, devices=n, phase_name="driver_on_mesh")
    return mesh_launches, ring_launches, mesh_polish


def run_multihost_phase(device="cuda", shards=2, timeout=300):
    """tests/_torch_multihost_worker.py in a subprocess joined to a one-rank
    process group (NCCL on the card) through the env-var launch recipe,
    against the same `shards`-shard run in this process without a group:
    the dense and PCG costs bit for bit, and the PCG within 1e-6 of the
    dense."""
    import socket

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_multihost_worker as worker

    from sphericalsfm_tpu_torch.eval import bench

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, SPHERICALSFM_COORDINATOR=f"127.0.0.1:{port}",
               SPHERICALSFM_NUM_PROCESSES="1", SPHERICALSFM_PROCESS_ID="0",
               PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as d:
        out_path = os.path.join(d, "rank0.json")
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests",
                                                              "_torch_multihost_worker.py"),
                                 out_path, device, str(shards)], env=env, cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            log, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"multihost worker exited {proc.returncode}:\n{log[-3000:]}")
        with open(out_path) as f:
            res = json.load(f)
    local, local_s = bench.timed(lambda: worker.run(device, shards), torch.device(device),
                                 reps=1, warmup=0)
    keys = ("cost", "cam_r", "points", "cost_pcg", "cam_r_pcg")
    equal = {k: res[k] == local[k] for k in keys}
    pcg_rel = abs(res["cost_pcg"] - res["cost"]) / max(abs(res["cost"]), 1e-300)
    phase("multihost", backend=res["backend"], world_size=res["world_size"],
          distributed=res["distributed"], shards=shards, cost=res["cost"],
          cost_pcg=res["cost_pcg"], initial_cost=res["initial_cost"],
          bit_equal_to_in_process=equal, pcg_rel_to_dense=pcg_rel,
          subprocess_wall_s=round(wall, 3), in_process_s=round(local_s, 3))
    if not (res["distributed"] and res["world_size"] == 1
            and res["backend"] == ("nccl" if device == "cuda" else "gloo")):
        raise AssertionError(f"worker did not join a one-rank group: {res}")
    if not all(equal.values()):
        raise AssertionError(f"one-rank group differs from the in-process run: {equal}")
    if not (pcg_rel <= 1e-6 or abs(res["cost_pcg"] - res["cost"]) <= 1e-18):
        raise AssertionError(f"PCG {res['cost_pcg']} vs dense {res['cost']}")


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_share(trace_path):
    """Device busy share of a torch.profiler Chrome trace: the union of the
    kernel, memcpy and memset intervals over the span of all complete
    ("X") events. Streams the file line by line, reading each event's
    "ph", "cat", "ts" and "dur" fields in order, so a multi-GB trace is not
    loaded whole."""
    import re

    field = re.compile(r'"(ph|cat|ts|dur)": "?([^",]*)"?')
    dev, lo, hi, events = [], math.inf, -math.inf, 0
    ph = cat = ts = None
    with open(trace_path) as f:
        for line in f:
            for key, val in field.findall(line):
                if key == "ph":
                    ph, cat, ts = val, None, None
                elif key == "cat":
                    cat = val
                elif key == "ts":
                    ts = float(val)
                elif ph == "X" and ts is not None:
                    end = ts + float(val)
                    events += 1
                    lo, hi = min(lo, ts), max(hi, end)
                    if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                        dev.append((ts, end))
    dev.sort()
    busy, end = 0.0, -math.inf
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = hi - lo
    return dict(busy_share=busy / wall if wall > 0 else 0.0, device_busy_s=busy / 1e6,
                traced_s=wall / 1e6, events=events, device_events=len(dev))


LONG_CAPTURE = dict(F=540, W=640, H=480, focal=560.0, seed=7)  # eval suite's base_f560 look


def run_long_capture_phase(two_nn, device="cuda", spec=LONG_CAPTURE):
    """The calibrated driver on a 540-frame sweep (18 s of 30 fps video,
    every frame a keyframe): windows matching (2514 pairs, 79 launches),
    rotation averaging on the PCG (540 > 400 frames), all four BA passes on
    the PCG (540 cameras → 624 on the JAX map's ladder > 512), cold, traced
    with cfg.profile_dir. Then the joint rotations + focal graph on the
    run's rotation graph, with its measured relative rotations and with the
    ground truth's, by the PCG and the dense solve."""
    from sphericalsfm_tpu_torch.eval import suite
    from sphericalsfm_tpu_torch.eval.metrics import ate, rotation_error_deg
    from sphericalsfm_tpu_torch.eval.render import render_capture
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.geometry.so3 import np_so3_exp, np_so3_log
    from sphericalsfm_tpu_torch.interop import rotation_graph_from_numpy
    from sphericalsfm_tpu_torch.optim import ba, pose_graph
    from sphericalsfm_tpu_torch.pipeline import driver
    from sphericalsfm_tpu_torch.pipeline.frontend import window_pairs

    F, W, H, focal = spec["F"], spec["W"], spec["H"], spec["focal"]
    t0 = time.perf_counter()
    cam_r, cam_t, gray, color = render_capture(
        num_frames=F, arc=1.0, focal=focal, width=W, height=H, seed=spec["seed"], n_waves=600,
        wave_freq=25.0 * W / 320.0, device=device)
    render_s = time.perf_counter() - t0
    cfg = suite.sequence_config(dict(frames=F, width=W))
    pairs = len(window_pairs(F, cfg.frontend.adjacent_window, cfg.graph.num_frames_begin,
                             cfg.graph.num_frames_end)[0])
    chunks = math.ceil(pairs / CHUNK)
    polish_expected = polish_parts(pairs, cfg.ransac.pair_chunk)

    graph = {}
    real = driver.optimize_rotations

    def capture(rot0, g, *args, **kw):  # keeps the run's rotation graph
        graph.update(rot0=rot0, g=g)
        return real(rot0, g, *args, **kw)

    reset_counts(two_nn)
    ba.bundle_adjust.solves.update(dense=0, pcg=0)
    pose_graph.optimize_rotations.solves.update(dense=0, pcg=0)
    with tempfile.TemporaryDirectory() as out:
        cfg.profile_dir = os.path.join(out, "trace")
        driver.optimize_rotations = capture
        try:
            t0 = time.perf_counter()
            m = driver.run_calibrated(None, Intrinsics(focal, W / 2.0, H / 2.0), out, cfg,
                                      gray=gray, color=color, device=device)
            sync(device)
            wall = time.perf_counter() - t0
        finally:
            driver.optimize_rotations = real
        launches, routes = two_nn.launches, dict(two_nn.route_launches)
        polish = polish_launches()
        ba_solves = dict(ba.bundle_adjust.solves)
        pg_solves = dict(pose_graph.optimize_rotations.solves)
        trace = os.path.join(cfg.profile_dir, "trace.json")
        trace_bytes = os.path.getsize(trace) if os.path.exists(trace) else 0
        t0 = time.perf_counter()
        busy = busy_share(trace) if trace_bytes else {}
        busy["parse_s"] = round(time.perf_counter() - t0, 3)
        missing = [f for f in ("poses.txt", "points.obj", "cameras.obj", "summary.json",
                               "stages.jsonl", "frontend.npz", "pre-loop-cameras.obj",
                               "sparse/model/cameras.txt", "sparse/model/images.txt",
                               "sparse/model/points3D.txt")
                   if not os.path.exists(os.path.join(out, f))]
        stages = [json.loads(line) for line in open(os.path.join(out, "stages.jsonl"))]
    del gray, color

    R_gt = np_so3_exp(cam_r)
    err = float(ate(m.centers(), -np.einsum("cji,cj->ci", R_gt, cam_t)))
    R = np_so3_exp(m.cam_r)
    rel = rotation_error_deg(np.einsum("nij,kj->nik", R, R[0]),
                             np.einsum("nij,kj->nik", R_gt, R_gt[0])).numpy()
    ba_passes = {}
    for s in stages:
        for k in range(1, 5):
            if f"ba{k}_iterations" in s:
                ba_passes[f"ba{k}"] = {key: s[f"ba{k}_{key}"] for key in (
                    "solver", "iterations", "pcg_iterations", "initial_cost", "final_cost",
                    "solve_s")}
                ba_passes[f"ba{k}"]["pcg_per_lm_step"] = (
                    s[f"ba{k}_pcg_iterations"] / max(s[f"ba{k}_iterations"], 1))

    # the joint rotations + focal graph on the run's edges: with the measured
    # relative rotations, and with the ground truth's (whose optimum is 1)
    g = graph["g"]
    ei, ej, w = (x.cpu().numpy() for x in (g.edge_i, g.edge_j, g.edge_w))
    r_meas = g.r_meas.cpu().numpy()
    r_true = np_so3_log(np.einsum("eij,ekj->eik", R_gt[ej], R_gt[ei]))
    ratio = np.linalg.norm(r_meas, axis=-1) / np.maximum(np.linalg.norm(r_true, axis=-1), 1e-12)
    gap = ej - ei
    angle_ratio = {name: float(np.median(ratio[sel & (w > 0)])) for name, sel in (
        ("gap2", gap == 2), ("gap3", gap == 3), ("loop", gap > 3)) if (sel & (w > 0)).any()}
    mult, focal_s = {}, {}
    for name, rm in (("measured", r_meas), ("ground_truth", r_true)):
        gg = rotation_graph_from_numpy(ei, ej, rm, w, device=device)
        mult[name] = {}
        for solver in ("pcg", "dense"):
            t0 = time.perf_counter()
            _, fm, _ = pose_graph.optimize_rotations_and_focal(graph["rot0"], gg, 1.0, 0.5, 2.0,
                                                               solver=solver)
            mult[name][solver] = float(fm)
            sync(device)
            focal_s[f"{name}_{solver}"] = round(time.perf_counter() - t0, 3)
    phase("long_capture", frames=F, size=f"{W}x{H}", pairs=pairs, render_s=round(render_s, 3),
          wall_s=round(wall, 3), ate=err, median_rel_rot_deg=float(np.median(rel)),
          points=int(m.point_valid().sum()), launches=launches, route_launches=routes,
          expected_launches=chunks, polish_launches=polish,
          expected_polish_launches=polish_expected, ba_solves=ba_solves,
          rotation_solves=pg_solves,
          ba=ba_passes, stage_s={s["stage"]: s["seconds"] for s in stages},
          trace_bytes=trace_bytes, trace=busy, focal_mult=mult, focal_graph_s=focal_s,
          measured_over_true_angle=angle_ratio, live_edges=int((w > 0).sum()))
    failures = []
    if missing:
        failures.append(f"outputs missing: {missing}")
    if not err < 0.05:
        failures.append(f"ATE {err} >= 0.05")
    if not np.median(rel) < 2.0:
        failures.append(f"median relative rotation error {np.median(rel)} >= 2 deg")
    if launches != chunks or routes["wgmma_bf16"] != chunks:
        failures.append(f"matcher launched {routes}, expected {chunks} bf16 launches")
    if polish != polish_expected:
        failures.append(f"polish launched {polish} times, expected {polish_expected}")
    if ba_solves != {"dense": 0, "pcg": 4}:
        failures.append(f"BA passes by solver {ba_solves}, expected 4 on the PCG")
    if pg_solves != {"dense": 0, "pcg": 1}:
        failures.append(f"rotation averaging by solver {pg_solves}, expected the PCG")
    if not trace_bytes:
        failures.append("no trace written")
    # the measured graph's optimum is not 1 on this capture (its 1.3° and 2°
    # edges come out short), so only the ground truth's is held to 1.0
    if not all(abs(v["pcg"] - v["dense"]) < 1e-3 for v in mult.values()) or not all(
            abs(v - 1.0) < 0.01 for v in mult["ground_truth"].values()):
        failures.append(f"focal multipliers {mult}")
    if failures:
        raise AssertionError(f"long_capture failed: {failures}")
    return launches, polish


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sphericalsfm_tpu_torch.device import resolve_device
    from sphericalsfm_tpu_torch.ops import cuda_libs
    from sphericalsfm_tpu_torch.ops import matching_kernel as mk

    resolve_device("cuda")  # TF32 off
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])

    t0 = time.perf_counter()
    libs = cuda_libs.build_libraries(verbose=True)
    two_nn, reference = mk.two_nearest_neighbors, mk.two_nn_reference
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()})

    k, tables = check_kernel(two_nn, reference)
    k["timing"] = {name: time_kernel(two_nn, reference, tables[name])
                   for name in ("32x1024", "32x4000")}
    phase("kernel", **k)
    del tables
    pol = run_polish_phase()

    main_launches, workflow = run_main_path(two_nn)
    launches = {"main": main_launches}
    # the final polish's launches by path, each checked there: one a chunk a part
    polish = {"polish": pol["launches"], "main": workflow["polish_launches"]}
    run_determinism_phase(workflow["gray"], workflow["color"],
                          {s: (workflow["rot0"], workflow["graph"], s) for s in ("dense", "pcg")})
    launches["static_ransac"], static = run_main_path(two_nn, static=True)
    polish["static_ransac"] = static["polish_launches"]
    del static
    # the adaptive engine again, warm, for its pairwise seconds beside
    # the static run's in one process
    polish["adaptive_warm"] = run_main_path(two_nn, phase_name="adaptive_warm")[1][
        "polish_launches"]
    launches["match_k4000"] = run_match_k4000(two_nn, reference, workflow["gray"],
                                              workflow["color"])
    launches["mesh"], launches["ring"], polish["mesh"] = run_mesh_phase(
        two_nn, reference, workflow["gray"], workflow["color"])
    run_multihost_phase()
    launches["uncalibrated"], polish["uncalibrated"] = run_uncalibrated_phase(two_nn)
    launches["modes"], polish["modes"] = run_modes_phase(two_nn)
    run_solvers_phase()
    launches["bench"], launches["bench_f32"] = run_bench_phase(two_nn)
    with tempfile.TemporaryDirectory() as tmp:
        case5 = config5_case(tmp)
        flows = run_flow_phase(case5["pair"][0])
        poses_b = run_panorama_phase(case5, flows, workflow, tmp)
        run_circle_views_phase(poses_b, workflow, os.path.join(tmp, "views"))
        del case5, flows
    del workflow
    run_ba_scale_phase()
    torch.cuda.empty_cache()
    launches["long_capture"], polish["long_capture"] = run_long_capture_phase(two_nn)

    t_main = k["timing"]["32x1024"]
    bf16_keys = {c: c for c in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                "share_of_bound")}
    f32_keys = {"ms": "fma_f32_ms", "plain_ms": "plain_f32_ms", "library_ms": "library_f32_ms",
                "bound_ms": "f32_bound_ms", "bound_by": "f32_bound_by",
                "share_of_bound": "f32_share_of_bound"}
    routes = (("two_nn", "two_nn_wgmma.cu", "main", k["max_abs_err"], bf16_keys, "bf16"),
              ("two_nn_f32", "two_nn.cu", "ring", k["f32_max_abs_err"], f32_keys, "float32"))
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"sphericalsfm_tpu_torch/csrc/{src}",
        "replaces": "sphericalsfm_tpu/ops/pallas_matching.py:32",
        "launches": launches[path],
        "launches_path": path,
        "max_abs_err": err,
        **{key: t_main[keys[key]] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms")},
        "shape": f"32x1024 {dtype}",
        "launches_by_phase": launches,
        "by_shape": {shape: {key: t[col] for key, col in keys.items()}
                     for shape, t in k["timing"].items()},
    } for name, src, path, err, keys, dtype in routes]
    kernels.append({
        "name": "spherical_polish",
        "route": "cuda",
        "source": "sphericalsfm_tpu_torch/csrc/spherical_polish.cu",
        "replaces": "sphericalsfm_tpu/ransac/spherical.py:56 (plain XLA, no Pallas kernel)",
        "launches": polish["main"],
        "launches_path": "main",
        "r_rel_max": pol["r_rel_max"],
        **{key: pol[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "shape": f"{pol['pairs']}x{pol['matches']} float64",
        "launches_by_phase": polish,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
