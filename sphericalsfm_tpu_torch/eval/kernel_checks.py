"""Each hand-written CUDA kernel's contract on the card, one section a
kernel (two-NN, polish, round) after the shared timer and launch counts:
the inputs it is held on, its agreement with the plain PyTorch path, its
operation count and bound on an H100, its launches on a pairwise sweep.
`chip_smoke.py`, the round benchmark, `scripts/bench_two_nn.py` and the
tests import them from here; the CPU tests hold the checks themselves on
the plain path's own outputs."""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from ..geometry.essential import decompose_spherical_essential, make_spherical_essential
from ..geometry.so3 import so3_exp
from ..ransac import spherical as sph
from ..ransac.engine import msac_score, sample_tuples
from ..solvers.spherical import solve_spherical_3pt
from .synthetic import make_random_problems

H100_BF16_FLOPS = 989e12   # dense, 700 W (NVIDIA's data sheet)
H100_FP32_FLOPS = 67e12    # outside the tensor cores, 700 W (the same sheet)
H100_FP64_FLOPS = 33.5e12  # FP64 outside the tensor cores, 700 W (the same sheet)
H100_HBM_BYTES = 3.35e12


# --------------------------------------------------------------------------
# shared


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of work queued back to back: on CUDA by events
    around `reps` calls queued while the card sleeps (host overhead between
    calls is not timed), on the CPU by the host clock."""
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _chunk_parts(pairs: int, chunk: int, devices: int = 0) -> list:
    """The parts of each chunk of a pairwise sweep: a chunk grown with the
    mesh and split over its shards as `estimate_pairwise` grows and splits
    it."""
    nd = max(devices, 1)
    if devices:
        chunk = -(-chunk // nd) * nd * max(1, nd // 8)
    return [min(nd, pairs - s) for s in range(0, pairs, chunk)]


def polish_parts(pairs: int, chunk: int, devices: int = 0) -> int:
    """Polish launches of one pairwise RANSAC sweep: one a part of each
    chunk."""
    return sum(_chunk_parts(pairs, chunk, devices))


def ransac_launches(polish: int, rounds: int, record: dict, pairs: int, chunk: int,
                    devices: int = 0, kernels: bool = True):
    """The RANSAC kernels' launches of one pairwise sweep against what it
    must launch, from the counters' `polish` and `rounds` and the sweep's
    `estimate_pairwise` stage `record`: the polish one a part of each chunk;
    the round kernel rounds × parts with the adaptive engine (the record's
    `rounds`, and its `round_launches` the same count), one a part of each
    chunk with the static one; none of either where `kernels` is False (the
    five-point engine). Returns (the counts and expectations, failures)."""
    parts = _chunk_parts(pairs, chunk, devices)
    adaptive = "rounds" in record
    if not kernels:
        want_polish = want_rounds = 0
    elif adaptive:     # a chunk runs its rounds on each of its parts
        want_polish = sum(parts)
        want_rounds = record["rounds"] * parts[0] if len(set(parts)) == 1 else None
    else:
        want_polish = want_rounds = sum(parts)
    info = dict(polish_launches=polish, expected_polish_launches=want_polish,
                round_launches=rounds, expected_round_launches=want_rounds,
                recorded_round_launches=record.get("round_launches"))
    failures = []
    if polish != want_polish:
        failures.append(f"polish launched {polish} times, expected {want_polish}")
    if rounds != want_rounds or (adaptive and record.get("round_launches") != rounds):
        failures.append(f"round kernel launched {rounds} times (recorded "
                        f"{record.get('round_launches')}), expected {want_rounds}")
    return info, failures


# --------------------------------------------------------------------------
# two-NN


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
# (distance tolerance, index gap) of each kernel against its plain version:
# bf16 inputs with float32 sums taken in another order than the plain
# version's; float32 sums in another order. Indices must be identical where
# the plain version's m2 − m1 > gap.
MATCH_TOL = {torch.bfloat16: (1e-4, 2e-4), torch.float32: (1e-5, 1e-5)}


def plain_check(got, ref, qvalid, dtype):
    """A two-NN kernel's (m1, m2, idx) against its plain version at
    MATCH_TOL[dtype]: the largest distance error on valid queries, whether
    the indices are equal wherever the plain version separates m1 from m2
    by more than the index gap, whether every invalid query is +inf, and
    `ok` when all three hold."""
    atol, gap = MATCH_TOL[dtype]
    (m1, m2, nn), (r1, r2, rn) = got, ref
    err = max(float((m1[qvalid] - r1[qvalid]).abs().max()),
              float((m2[qvalid] - r2[qvalid]).abs().max()))
    sep = qvalid & (r2 - r1 > gap)
    same_idx = bool(torch.equal(nn[sep], rn[sep]))
    inv_inf = bool(torch.isinf(m1[~qvalid]).all() and torch.isinf(m2[~qvalid]).all())
    return dict(max_abs_err=err, indices_equal=same_idx, invalid_inf=inv_inf,
                ok=err <= atol and same_idx and inv_inf)


def accepted(out, qvalid, ratio=0.75):
    m1, m2, nn = out
    return (m1 < ratio * ratio * m2) & torch.isfinite(m1) & qvalid, nn


def match_agreement(a, b, qvalid):
    """|∩| / |∪| of the ratio-test-accepted (pair, query, train) matches."""
    (acc_a, nn_a), (acc_b, nn_b) = accepted(a, qvalid), accepted(b, qvalid)
    both = int((acc_a & acc_b & (nn_a == nn_b)).sum())
    return both, int(acc_a.sum()) + int(acc_b.sum()) - both


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
        runs[k].append(device_ms(fns[k], desc.device,
                                  reps=20 if k in ("ms", "plain_ms", "library_ms") else 10))
    out = {k: min(v) for k, v in runs.items()}
    out["bound_ms"], out["bound_by"] = two_nn_bound(desc, valid, pi, pj)
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    out["f32_bound_ms"], out["f32_bound_by"] = two_nn_f32_bound(desc, valid, pi, pj)
    out["f32_share_of_bound"] = out["f32_bound_ms"] / out["fma_f32_ms"]
    out["runs"] = runs
    return out


# --------------------------------------------------------------------------
# polish


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
    prob = make_random_problems(torch.Generator().manual_seed(seed), B, N, inward=inward,
                                rotation_deg=rotation_deg, point_noise=1.0 / 600, device="cpu")
    rng = np.random.default_rng(seed)
    out = rng.uniform(size=(B, N)) < rng.uniform(*outliers, size=(B, 1))
    v = prob.v.numpy().copy()
    v[..., :2] = np.where(out[..., None], rng.normal(size=(B, N, 2)) * 0.5, v[..., :2])
    u, v = (torch.as_tensor(x, dtype=dtype, device=device) for x in (prob.u.numpy(), v))
    mask = prob.valid.to(device)
    sq = (2.0 / 600) ** 2
    res = sph.spherical_ransac_adaptive(torch.Generator(device=device).manual_seed(seed + 1), u,
                                        v, mask, sq, max_rounds=79, inward=inward,
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
    r0, u, v, mask, inliers, E, score, sq = args
    same = k.iterations == p.iterations
    rel = (torch.linalg.norm(k.r - p.r, dim=-1)
           / torch.linalg.norm(p.r, dim=-1).clamp(min=1e-300))
    errs = sph.sampson_error(make_spherical_essential(so3_exp(p.r), inward=inward), u, v)
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


# --------------------------------------------------------------------------
# round


# Floating-point operations of the RANSAC round (csrc/spherical_round.cu),
# counted from its arithmetic: a product or sum is 1, a math-library call
# (sqrt, hypot, atan2, pow, cos, sin) 1.
ROUND_SOLVE_FLOPS = 6140  # a triple: the epipolar rows (30); Gram-Schmidt of them (129),
#                           the six residuals (432) and their norms (78), Gram-Schmidt of
#                           the three kept (129); at each of 10 nodes its parameters (30),
#                           E Eᵀ (45), its trace (2), 2 E Eᵀ E − tr E (72), det E (14) and
#                           the node's share of C (200); C1ᵀC1's lower half (420), C1ᵀC2
#                           (480), the Cholesky (91), forward (144) and the two last rows
#                           back (16); the quartic's coefficients (3) and roots (174);
#                           2 Newton steps on 4 roots (152); x (36), p, its norm and the
#                           division (196)
ROUND_SCORE_FLOPS = 38    # a candidate and a valid match: E u (13), Eᵀv's first two (10),
#                           vᵀEu (5), the denominator (7), d² (1), thr·den (1), the sum (1);
#                           the division, made only under the threshold, is not counted
ROUND_INLIER_FLOPS = 37   # a match of a pair that keeps its round's best: the error (36)
#                           and its division


def round_flops(valid_rows, R: int, N: int, kept: int = 0) -> float:
    """Operations of one round call: for each active pair, whose valid
    matches `valid_rows` counts, R solves and 4R candidates scored over its
    valid matches; then N errors for each of the `kept` pairs whose round
    best replaced its running best."""
    rows = float(valid_rows.sum()) if torch.is_tensor(valid_rows) else float(sum(valid_rows))
    active = valid_rows.numel() if torch.is_tensor(valid_rows) else len(valid_rows)
    return (active * R * ROUND_SOLVE_FLOPS + 4 * R * rows * ROUND_SCORE_FLOPS
            + kept * N * ROUND_INLIER_FLOPS)


def round_inputs(B, R, N, dtype=torch.float64, seed=0, device="cuda", active_share=0.6,
                 outliers=(0.3, 0.7), rotation_deg=-1.0):
    """One round's inputs at B pairs × R triples × N matches: rays of random
    spherical problems (1 px noise at f = 600; rotations uniform in [0, π)
    by default) with a share of outliers drawn per pair from `outliers`,
    each pair's valid matches a prefix of N/2 to N rows (the rest filled
    with junk rays); the running best after one plain round of other
    triples from no model, the round's triples from `sample_tuples` and an
    active flag drawn per pair at `active_share`. Returns (triples, u, v,
    mask, E, score, inliers, active, sq_thresh)."""
    prob = make_random_problems(torch.Generator().manual_seed(seed), B, N,
                                rotation_deg=rotation_deg, point_noise=1.0 / 600, device="cpu")
    rng = np.random.default_rng(seed)
    out = rng.uniform(size=(B, N)) < rng.uniform(*outliers, size=(B, 1))
    u, v = prob.u.numpy().copy(), prob.v.numpy().copy()
    v[..., :2] = np.where(out[..., None], rng.normal(size=(B, N, 2)) * 0.5, v[..., :2])
    mask = prob.valid.numpy() & (np.arange(N) < rng.integers(N // 2, N + 1, size=(B, 1)))
    u[~mask] = rng.normal(size=(int((~mask).sum()), 3)) * 1e3
    u, v = (torch.as_tensor(x, dtype=dtype, device=device) for x in (u, v))
    mask = torch.as_tensor(mask, device=device)
    sq = (2.0 / 600) ** 2
    gen = torch.Generator().manual_seed(seed + 1)
    first = sample_tuples(gen, mask.cpu(), R, 3).to(device)
    start = sph._round_plain(sph._start(u, v, mask), first,
                             torch.ones(B, dtype=torch.bool, device=device), sq)
    triples = sample_tuples(gen, mask.cpu(), R, 3).to(device)
    active = torch.as_tensor(rng.uniform(size=B) < active_share, device=device)
    return triples, u, v, mask, start.E, start.score, start.inliers, active, sq


def round_plain_candidates(args):
    """The plain round's candidates on the inputs' device: E (B, 4R, 3, 3),
    valid and MSAC scores (B, 4R), as `engine.best_model` scores them."""
    triples, u, v = args[:3]
    B = u.shape[0]
    Es, valid = solve_spherical_3pt(sph._gather_rows(u, triples), sph._gather_rows(v, triples))
    Es, valid = Es.reshape(B, -1, 3, 3), valid.reshape(B, -1)
    return Es, valid, candidate_scores(args, Es, valid)


def _scored(args, Es):
    """The plain MSAC scores (B, S) of candidates Es (B, S, 3, 3) over the
    inputs' matches, and their Sampson errors (B, S, N)."""
    u, v, mask, sq = args[1], args[2], args[3], args[8]
    errs = sph.sampson_error(Es, u[:, None], v[:, None])
    errs = torch.where(torch.isfinite(errs), errs, torch.full_like(errs, float("inf")))
    return msac_score(errs, sq, mask[:, None, :]), errs


def candidate_scores(args, Es, valid):
    """The MSAC scores (B, S) of candidates Es (B, S, 3, 3), as
    `engine.best_model` scores them: +inf where not `valid`."""
    return torch.where(valid, _scored(args, Es)[0],
                       torch.full_like(valid, float("inf"), dtype=args[1].dtype))


def round_witness(args):
    """The plain solve's candidates (E, valid) for the inputs' triples
    computed on the CPU and moved to the inputs' device: the reference run
    again with other reductions and math libraries, so what it moves
    against the plain solve on the card is what rounding alone moves."""
    triples, u, v = (x.cpu() for x in args[:3])
    B = u.shape[0]
    Es, valid = solve_spherical_3pt(sph._gather_rows(u, triples), sph._gather_rows(v, triples))
    dev = args[1].device
    return Es.reshape(B, -1, 3, 3).to(dev), valid.reshape(B, -1).to(dev)


def candidate_residuals(args, Es):
    """Each candidate's residuals (B, 4R) on its own triple, both zero for
    a true solution however ill conditioned the solve that found it: the
    largest |vᵀEu| of the triple's three correspondences (unit rays, E
    scaled to ‖E‖ = 1), and the largest entry of the essential-matrix
    constraint 2EEᵀE − tr(EEᵀ)E of E scaled so."""
    triples, u, v = args[:3]
    B, R = triples.shape[:2]
    uu, vv = sph._gather_rows(u, triples), sph._gather_rows(v, triples)
    uu = uu / uu.norm(dim=-1, keepdim=True)
    vv = vv / vv.norm(dim=-1, keepdim=True)
    E = Es.reshape(B, R, 4, 3, 3)
    E = E / E.flatten(-2).norm(dim=-1).clamp_min(torch.finfo(E.dtype).tiny)[..., None, None]
    epipolar = torch.einsum("brki,brcij,brkj->brck", vv, E, uu).abs().amax(-1)
    EEt = E @ E.transpose(-1, -2)
    trace = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)
    essential = (2 * EEt @ E - trace[..., None, None] * E).abs().flatten(-2).amax(-1)
    return epipolar.reshape(B, 4 * R), essential.reshape(B, 4 * R)


def round_sensitivity(args, draws=2, seed=0):
    """How far the plain solve's own candidates move when its rays move by
    one rounding: for each candidate (B, 4R), the largest distance over
    `draws` draws (every coordinate of u and v times 1 + kε, k in
    {-1, 0, 1}) to the nearest candidate of its triple. The solve hangs on
    rounding where C1ᵀC1 is ill conditioned, near double roots, and in the
    spurious candidates from a complex pair's real part."""
    triples, u, v = args[:3]
    B = u.shape[0]

    def solve(uu, vv):
        Es, _ = solve_spherical_3pt(sph._gather_rows(uu, triples), sph._gather_rows(vv, triples))
        return Es.reshape(B, -1, 3, 3)

    Ep = solve(u, v)
    gen = torch.Generator(device=u.device).manual_seed(seed)
    eps = torch.finfo(u.dtype).eps

    def moved(x):
        k = torch.randint(-1, 2, x.shape, generator=gen, device=x.device).to(x.dtype)
        return x * (1 + eps * k)

    out = torch.zeros(Ep.shape[:2], dtype=Ep.dtype, device=Ep.device)
    for _ in range(draws):
        out = torch.maximum(out, _nearest(Ep, solve(moved(u), moved(v)))[0])
    return out


def _nearest(Ea, Eb):
    """For each candidate of Ea (B, 4R, 3, 3), the distance (largest entry)
    to the nearest candidate of the same triple in Eb, and that candidate's
    index (B, 4R). Rounding may hand a triple's roots to its four slots in
    another order (the sign of a rounding-size imaginary part picks the
    branch of a complex square root), so a triple's candidates are matched
    as a set."""
    B, S = Ea.shape[:2]
    d = (Ea.reshape(B, S // 4, 4, 1, 9) - Eb.reshape(B, S // 4, 1, 4, 9)).abs().amax(-1)
    gap, j = d.min(-1)
    first = torch.arange(0, S, 4, device=Ea.device)[None, :, None]
    return gap.reshape(B, S), (first + j).reshape(B, S)


def _root_flips(Ea, va, ra, Eb, rb, root):
    """The candidates of Ea (where `va`) that solve their triple, their
    essential residual `ra` at most `root`, whose nearest candidate of the
    same triple in Eb does not: its residual `rb` more than 10× theirs, or
    than `root`."""
    rb_near = rb.gather(1, _nearest(Ea, Eb)[1])
    return va & (ra <= root) & (rb_near > 10 * torch.clamp(ra, min=root))


# A candidate's |vᵀEu| on its own triple, in ε: at most 5.1e-13 (2,300 ε) for
# the kernel's 262,144 candidates of four 128 × 128 chunks on an H100, and
# 1.1e-12 for the plain solve's there.
ROUND_EPIPOLAR_EPS = 2 ** 14
# An essential residual of at most this many ε (1.2e-10 in float64) makes a
# candidate a solution of its triple; the spurious ones, from a complex pair's
# real part, read 1e-3 to 1.
ROUND_ROOT_EPS = 2 ** 19


def round_agreement(args, k, kc, p, pc, sens, rel=1e-9, tie=1e-9):
    """The kernel's round `k` (RoundResult) and candidates `kc` against the
    plain round's `p` (its _Part) and candidates `pc` (round_plain_candidates)
    on the float64 inputs `args` (round_inputs' tuple), for the active
    pairs. Candidates: each triple with as many valid; each plain candidate
    matched to the nearest kernel candidate of its triple (rounding may
    hand the roots to the slots in another order), at the 50th, 90th, 99th
    and 99.9th percentiles (those with ten candidates or more above them)
    no farther than 10× the plain solve's own move under a one-rounding
    change of its rays (`sens`, round_sensitivity) or 1e-12: the plain
    solve itself moves by up to ~1 on ill-conditioned triples, so no second
    implementation matches every candidate. Candidate by candidate, with
    the plain solve on the CPU as a witness (round_witness): every valid
    candidate within ROUND_EPIPOLAR_EPS of its own triple's three epipolar
    constraints (candidate_residuals); the plain solutions whose nearest
    kernel candidate is no solution (ROUND_ROOT_EPS), and the kernel's
    solutions whose nearest plain candidate is none, each at most 3× the
    witness's count and 5; the candidates farther from the plain solve
    than 10× their own `sens`, at most 4× the witness's count and 10. Every
    candidate's MSAC score within `rel` relative (or 1e-12 of one capped
    match) of the plain scoring of the kernel's own E (the score moves with
    E at up to 1/|vᵀEu| of the inliers). The round: the same best (its E
    within `rel`) except where the plain round's two lowest scores lie within
    `tie` relative (or 1e-12 of one capped match); the same keep except
    there or where the best scores that close to the running one; for
    pairs both kept with the same best, E within `rel`, the score held as a
    candidate's and the inlier rows of the kept E (off the threshold, a
    match within `rel` relative of it); the kernel's kept model its own
    pick's candidate exactly; and every pair that did not keep (every
    inactive one) left as it was, bit for bit. Returns (the
    measures, failures)."""
    triples, u, v, mask, E, score, inliers, active, sq = args
    Ep, vp, sp = pc
    act = active
    B = u.shape[0]

    def close(a, b):
        return (a - b).abs() <= rel * b.abs() + 1e-12 * sq

    def pick(Es, i):
        return Es.gather(1, i[:, None, None, None].expand(-1, 1, 3, 3))[:, 0]

    cand = act[:, None] & vp
    E_gap = _nearest(Ep, kc.E)[0][cand]
    Ew, vw = round_witness(args)
    eps = torch.finfo(u.dtype).eps
    root = ROUND_ROOT_EPS * eps
    ep_k, rE_k = candidate_residuals(args, kc.E)
    ep_p, rE_p = candidate_residuals(args, Ep)
    rE_w = candidate_residuals(args, Ew)[1]
    k_cand, w_cand = act[:, None] & kc.valid, act[:, None] & vw

    def far(Es):                        # candidates farther than 10× their own sens
        return int((cand & (_nearest(Ep, Es)[0] > torch.clamp(10 * sens, min=1e-12))).sum())
    # the percentiles with ten candidates or more above them
    qs = torch.tensor([q for q in (0.5, 0.9, 0.99, 0.999) if (1 - q) * E_gap.numel() >= 10],
                      dtype=E_gap.dtype, device=E_gap.device)
    gap_q, sens_q = torch.quantile(E_gap, qs), torch.quantile(sens[cand], qs)
    both = act[:, None] & kc.valid & vp
    own_sc = _scored(args, kc.E)[0]
    ik, ip = torch.argmin(kc.score, -1), torch.argmin(sp, -1)
    low = torch.topk(sp, 2, dim=-1, largest=False).values
    pick_tie = (low[:, 1] - low[:, 0]).abs() <= tie * low[:, 0].abs() + 1e-12 * sq
    pick_gap = (pick(kc.E, ik) - pick(Ep, ip)).abs().flatten(1).amax(-1)
    best_p = low[:, 0]
    kept_p = act & (best_p < score)
    kept_k = act & (k.score < score)
    keep_tie = ((best_p - score).abs() <= tie * score.abs() + 1e-12 * sq) | pick_tie
    same = kept_k & kept_p & (pick_gap <= rel)
    k_sc, k_errs = _scored(args, k.E[:, None])
    near = ((k_errs[:, 0] - sq).abs() <= rel * sq) | ~torch.isfinite(k_errs[:, 0])
    k_inl = (k_errs[:, 0] < sq) & mask
    left = ~kept_k
    changed = ((k.E != E).flatten(1).any(-1) | (k.score != score)
               | (k.inliers != inliers).any(-1))

    def worst(x, sel):
        return float(x[sel].max()) if sel.any() else 0.0

    info = dict(active=int(act.sum()), candidates=int(act.sum()) * kc.valid.shape[1],
                valid_share=float(vp[act].double().mean()) if act.any() else None,
                valid_differ=int(((kc.valid.reshape(B, -1, 4).sum(-1)
                                   != vp.reshape(B, -1, 4).sum(-1)) & act[:, None]).sum()),
                E_gap_quantiles=gap_q.tolist(), plain_move_quantiles=sens_q.tolist(),
                E_gap_max=float(E_gap.max()) if E_gap.numel() else 0.0,
                E_gap_over_rel_share=float((E_gap > rel).double().mean())
                if E_gap.numel() else 0.0,
                over_10x_sens=far(kc.E), witness_over_10x_sens=far(Ew),
                epipolar_max=worst(ep_k, k_cand), plain_epipolar_max=worst(ep_p, cand),
                roots_lost=int(_root_flips(Ep, cand, rE_p, kc.E, rE_k, root).sum()),
                witness_roots_lost=int(_root_flips(Ep, cand, rE_p, Ew, rE_w, root).sum()),
                roots_gained=int(_root_flips(kc.E, k_cand, rE_k, Ep, rE_p, root).sum()),
                witness_roots_gained=int(_root_flips(Ew, w_cand, rE_w, Ep, rE_p, root).sum()),
                score_differ=int((~close(kc.score, own_sc) & both).sum()),
                picks_differ=int(((pick_gap > rel) & act & ~pick_tie).sum()),
                pick_ties=int((pick_tie & act).sum()),
                keeps_differ=int(((kept_k != kept_p) & ~keep_tie).sum()),
                kept=int(kept_k.sum()), kept_both_same_pick=int(same.sum()),
                kept_E_max_gap=worst((k.E - p.E).abs().flatten(1).amax(-1), same),
                kept_score_differ=int((~close(k.score, k_sc[:, 0]) & kept_k).sum()),
                inliers_differ=int(((k.inliers != k_inl) & ~near)[kept_k].sum()),
                kept_not_own_pick=int((((k.E != pick(kc.E, ik)).flatten(1).any(-1)
                                        | (k.score != kc.score.gather(1, ik[:, None])[:, 0]))
                                       & kept_k).sum()),
                unkept_changed=int((changed & left).sum()))
    failures = []
    if info["valid_differ"]:
        failures.append(f"valid candidates differ in number on {info['valid_differ']} triples")
    if not bool((gap_q <= torch.clamp(10 * sens_q, min=1e-12)).all()):
        failures.append(f"candidates differ by {gap_q.tolist()} at the percentiles where the "
                        f"plain solve moves {sens_q.tolist()}")
    if not info["epipolar_max"] <= ROUND_EPIPOLAR_EPS * eps:
        failures.append(f"a candidate misses its triple's epipolar constraints by "
                        f"{info['epipolar_max']}")
    for flip in ("lost", "gained"):
        n, w = info[f"roots_{flip}"], info[f"witness_roots_{flip}"]
        if n > 3 * w + 5:
            failures.append(f"{n} solutions of their triple {flip} against the plain "
                            f"solve, {w} by the witness")
    if info["over_10x_sens"] > 4 * info["witness_over_10x_sens"] + 10:
        failures.append(f"{info['over_10x_sens']} candidates beyond 10× the plain solve's own "
                        f"move, {info['witness_over_10x_sens']} of the witness's")
    if info["score_differ"]:
        failures.append(f"{info['score_differ']} candidate scores differ from their E's")
    if info["picks_differ"]:
        failures.append(f"the best candidate differs outside ties on {info['picks_differ']} pairs")
    if info["keeps_differ"]:
        failures.append(f"the keep differs outside ties on {info['keeps_differ']} pairs")
    if not info["kept_E_max_gap"] <= rel or info["kept_score_differ"]:
        failures.append(f"kept models differ by {info['kept_E_max_gap']}, "
                        f"{info['kept_score_differ']} kept scores from their E's")
    if info["inliers_differ"]:
        failures.append(f"{info['inliers_differ']} inlier flags differ off the threshold")
    if info["kept_not_own_pick"]:
        failures.append(f"{info['kept_not_own_pick']} kept models are not the kernel's pick")
    if info["unkept_changed"]:
        failures.append(f"{info['unkept_changed']} pairs that did not keep changed")
    return info, failures
