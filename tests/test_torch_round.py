"""The adaptive RANSAC round on the CPU: the plain round (`_round_plain`,
the kernel's reference) is the solve → score → masked keep the engines ran
before it, bit for bit, and both engines go through the one round entry
point (`_round`); the dispatch by device (CPU tensors never reach the
kernel; its wrapper refuses them, and wrong types, shapes and layouts);
the `round_launches` count of `estimate_pairwise`; and the round's
contract in `eval/kernel_checks.py` (its inputs, agreement checks and
operation count), which the smoke holds the kernel to. The kernel itself
is held to the plain round on the card by tests/test_torch_cuda_round.py."""

import math
import os

import pytest
import torch

from sphericalsfm_tpu_torch.eval import kernel_checks as checks
from sphericalsfm_tpu_torch.eval.experiments import _contaminate
from sphericalsfm_tpu_torch.eval.synthetic import make_random_problems
from sphericalsfm_tpu_torch.pipeline import pairwise as pw
from sphericalsfm_tpu_torch.ransac import spherical as sph
from sphericalsfm_tpu_torch.ransac.engine import sample_tuples
from sphericalsfm_tpu_torch.ransac.round_kernel import spherical_round
from sphericalsfm_tpu_torch.solvers.spherical import solve_spherical_3pt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SQ = (2.0 / 600) ** 2


def _problems(B=16, N=128, seed=0, outliers=0.4):
    prob = make_random_problems(torch.Generator().manual_seed(seed), B, N, rotation_deg=5.0,
                                point_noise=1.0 / 600, device="cpu")
    mask = prob.valid & (torch.arange(N) < N - 3 * torch.arange(B)[:, None])
    return prob.u, _contaminate(prob, outliers, seed + 1), mask


def _composed_round(part, triples, active):
    """Solve → score → masked keep, written out as the engines ran them."""
    B = part.u.shape[0]
    Es, valid = solve_spherical_3pt(sph._gather_rows(part.u, triples),
                                    sph._gather_rows(part.v, triples))
    E_r, sc, inl = sph._score_candidates(Es.reshape(B, -1, 3, 3), valid.reshape(B, -1),
                                         part.u, part.v, SQ, part.mask)
    return sph._keep_better(part, E_r, sc, inl, where=active)


def test_plain_round_is_solve_score_keep_bit_for_bit():
    """A seeded 16-pair chunk, half of it active, over two rounds: the
    plain round equals the written-out composition bit for bit, keeps only
    active pairs and leaves the others' running best untouched."""
    u, v, m = _problems()
    gen = torch.Generator().manual_seed(4)
    part = sph._start(u, v, m)
    for active in (torch.ones(16, dtype=torch.bool), torch.arange(16) % 2 == 0):
        triples = sample_tuples(gen, m, 32, 3)
        got = sph._round_plain(part, triples, active, SQ)
        want = _composed_round(part, triples, active)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(got.E[~active], part.E[~active])
        assert torch.equal(got.score[~active], part.score[~active])
        assert torch.equal(got.inliers[~active], part.inliers[~active])
        assert torch.isfinite(got.score).all()
        part = got


def _adaptive_by_hand(gen, u, v, m, round_size=128, max_rounds=8, min_rounds=2):
    """The adaptive engine's loop with the written-out round, no refit and
    no polish: (E, score, inliers, rounds)."""
    log1mp = math.log(1.0 - 0.99)
    part = sph._start(u, v, m)
    n_valid = torch.clamp(m.sum(-1), min=3).to(u.dtype)
    done = torch.zeros(u.shape[0], dtype=torch.int64)
    rnd = torch.zeros(u.shape[0], dtype=torch.int64)

    def running():
        w3 = torch.clamp(part.inliers.sum(-1).to(u.dtype) / n_valid, 0.0, 1.0) ** 3
        need = torch.where(w3 > 0, log1mp / torch.log1p(-torch.clamp(w3, max=1.0 - 1e-9)),
                           torch.full_like(w3, float("inf")))
        return (rnd < max_rounds) & ((rnd < min_rounds) | (done < need))

    act = running()
    while bool(act.any()):
        part = _composed_round(part, sample_tuples(gen, m, round_size, 3), act)
        done, rnd = done + act.long() * round_size, rnd + act.long()
        act = running()
    return part.E, part.score, part.inliers, rnd


@pytest.mark.parametrize("outliers", [0.0, 0.5])
def test_adaptive_engine_cpu_results_unchanged(outliers):
    """The adaptive engine on the CPU, without refit and polish, is the
    written-out loop of solve → score → masked keep, bit for bit: the same
    draws, the same running best, the same rounds."""
    u, v, m = _problems(B=12, N=96, seed=7, outliers=outliers)
    res = sph.spherical_ransac_adaptive(torch.Generator().manual_seed(9), u, v, m, SQ,
                                        lo_rounds=0, final_least_squares=False)
    E, score, inliers, rounds = _adaptive_by_hand(torch.Generator().manual_seed(9), u, v, m)
    assert torch.equal(res.E, E) and torch.equal(res.score, score)
    assert torch.equal(res.inlier_mask, inliers) and torch.equal(res.rounds, rounds)
    assert int(rounds.max()) >= 2


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_both_engines_take_the_one_round(devices, monkeypatch):
    """Both engines go through `_round`: the adaptive one once a part a
    round, every pair of a finished part inactive; the static one with
    every pair active, in blocks bounded by `_SCORE_BLOCK_ELEMS` on the
    CPU."""
    u, v, m = _problems(B=8, N=64, seed=2)
    calls = []
    real = sph._round

    def counted(part, triples, active, sq):
        calls.append((part.u.shape[0], triples.shape[1], bool(active.all())))
        return real(part, triples, active, sq)

    monkeypatch.setattr(sph, "_round", counted)
    res = sph.spherical_ransac_adaptive(torch.Generator().manual_seed(1), u, v, m, SQ,
                                        devices=devices)
    parts = 1 if devices is None else 2
    assert len(calls) == int(res.rounds.max()) * parts
    assert all(r == 128 for _, r, _ in calls)
    calls.clear()
    monkeypatch.setattr(sph, "_SCORE_BLOCK_ELEMS", 8 * 64 * 4 * 50 // parts)  # 50 triples a block
    sph.spherical_ransac(torch.Generator().manual_seed(1), u, v, m, SQ, num_hypotheses=256,
                         devices=devices)
    assert [r for _, r, _ in calls] == ([50] * 5 + [6]) * parts
    assert all(a for _, _, a in calls)


def test_cpu_tensors_never_reach_the_kernel():
    """The dispatch takes the plain round on CPU tensors, bit for bit, and
    launches nothing; the kernel's wrapper refuses CPU tensors rather than
    fall back, and refuses wrong types, shapes and layouts before that."""
    u, v, m = _problems(B=4, N=64, seed=3)
    gen = torch.Generator().manual_seed(2)
    part = sph._start(u, v, m)
    triples = sample_tuples(gen, m, 16, 3)
    act = torch.tensor([True, False, True, True])
    before = spherical_round.launches
    got, want = sph._round(part, triples, act, SQ), sph._round_plain(part, triples, act, SQ)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sph.spherical_ransac_adaptive(gen, u, v, m, SQ)
    sph.spherical_ransac(gen, u, v, m, SQ, num_hypotheses=64)
    assert spherical_round.launches == before
    args = [triples, u, v, m, part.E, part.score, part.inliers, act]
    with pytest.raises(ValueError, match="CUDA tensors"):
        spherical_round(*args, SQ)
    bad = {0: triples.int(), 1: u.half(), 3: m.to(torch.uint8), 6: part.inliers[:, :32],
           7: act[:3]}
    for i, x in bad.items():
        with pytest.raises(ValueError, match="must be|float32 or float64"):
            spherical_round(*args[:i], x, *args[i + 1:], SQ)
    with pytest.raises(ValueError, match="must be"):
        spherical_round(triples[..., :2], *args[1:], SQ)
    with pytest.raises(ValueError, match="contiguous"):
        spherical_round(triples.transpose(0, 1).contiguous().transpose(0, 1), *args[1:], SQ)
    with pytest.raises(ValueError, match="contiguous"):
        spherical_round(*args[:2], v.transpose(0, 1).contiguous().transpose(0, 1), *args[3:], SQ)
    assert spherical_round.launches == before


def test_estimate_pairwise_counts_round_launches():
    """The adaptive engine's `estimate_pairwise` record carries
    `round_launches` beside `rounds`: 0 on the CPU, where no kernel runs;
    the static engine's carries neither."""
    from tests.test_torch_polish import _sweep

    xy, pi, pj, idx0, idx1, mm, intr = _sweep()
    for adaptive in (True, False):
        res = pw.estimate_pairwise(torch.Generator().manual_seed(0), xy, pi, pj, idx0, idx1, mm,
                                   intr, min_num_inliers=20, chunk_size=10, num_hypotheses=256,
                                   adaptive=adaptive, device="cpu")
        assert ("round_launches" in res.counts) == ("rounds" in res.counts) == adaptive
        if adaptive:
            assert res.counts["round_launches"] == 0 and res.counts["rounds"] >= 6


@pytest.mark.parametrize("engine", ["adaptive", "static", "five_point"])
def test_pairwise_record_keys_follow_the_engine(engine):
    """Each engine's `estimate_pairwise` record, from the engine its entry
    point ran and not from its results: `chunks` always; the polish's
    counts for the spherical engines; the rounds and their launches for
    the adaptive one. No pair gives no chunk and no other key."""
    from tests.test_torch_polish import _sweep

    xy, pi, pj, idx0, idx1, mm, intr = _sweep()
    keys = {"adaptive": {"chunks", "polish_iters", "polish_accept_pct", "rounds", "active_pct",
                         "round_launches"},
            "static": {"chunks", "polish_iters", "polish_accept_pct"},
            "five_point": {"chunks"}}[engine]

    def run(P):
        gen = torch.Generator().manual_seed(0)
        args = (xy, pi[:P], pj[:P], idx0[:P], idx1[:P], mm[:P], intr)
        if engine == "five_point":
            return pw.estimate_pairwise_five_point(gen, *args, min_num_inliers=20,
                                                   num_hypotheses=32, chunk_size=10,
                                                   device="cpu")
        return pw.estimate_pairwise(gen, *args, min_num_inliers=20, chunk_size=10,
                                    num_hypotheses=256, adaptive=engine == "adaptive",
                                    device="cpu")

    res = run(len(pi))
    assert set(res.counts) == keys and res.counts["chunks"] == -(-len(pi) // 10)
    assert res.r.shape == (len(pi), 3) and res.inlier_mask.shape == mm.shape
    empty = run(0)
    assert empty.counts == {"chunks": 0} and empty.r.shape == (0, 3)


def test_round_flops_hand_count():
    """The operation count behind the kernel's FP64 bound at one small
    shape: 2 active pairs with 10 and 20 valid matches, 2 triples each, a
    row of 32 matches, one pair keeping its round's best."""
    flops = checks.round_flops(torch.tensor([10, 20]), 2, 32, kept=1)
    assert flops == 2 * 2 * 6140 + 4 * 2 * 30 * 38 + 32 * 37
    assert checks.round_flops([1024] * 128, 128, 1024) == 128 * (128 * 6140 + 512 * 1024 * 38)


def test_smoke_round_inputs():
    """The inputs the smoke and the card tests give the round, here on the
    CPU: shapes, types and layouts the kernel takes, ragged masks, junk in
    the masked rows, a running best from a first round, a mixed active
    flag, triples drawn from the valid rows."""
    args = checks.round_inputs(8, 16, 96, device="cpu")
    triples, u, v, mask, E, score, inliers, active, sq = args
    assert triples.shape == (8, 16, 3) and triples.dtype == torch.int64
    assert u.shape == v.shape == (8, 96, 3) and E.shape == (8, 3, 3)
    assert all(t.is_contiguous() for t in args[:8])
    valid = mask.sum(-1)
    assert (valid <= 96).all() and (valid < 48).any() and (valid > 48).any()
    assert (u[~mask].abs().amax(-1) > 10).float().mean() > 0.9
    assert torch.isfinite(score).all() and inliers.any(-1).all()
    assert active.any() and not active.all()
    drawn = mask.gather(1, triples.reshape(8, -1))
    assert drawn[valid >= 3].all() and sq == SQ


def _plain_round_outputs(args):
    triples, u, v, mask, E, score, inliers, active, sq = args
    part = sph._Part(u, v, mask, E, score, inliers)
    p = sph._round_plain(part, triples, active, sq)
    pc = checks.round_plain_candidates(args)
    return p, pc


@pytest.mark.parametrize("fault", ["none", "candidate", "score", "pick", "keep", "inliers",
                                   "inactive", "validity", "root", "epipolar"])
def test_smoke_round_agreement_catches_a_wrong_round(fault):
    """The smoke's round phase holds the kernel to the plain round with
    `kernel_checks.round_agreement`: the plain round against itself passes, and each
    fault a kernel could make (here applied to the plain round's own
    outputs on the CPU) fails it."""
    from sphericalsfm_tpu_torch.ransac.round_kernel import RoundCandidates, RoundResult

    args = checks.round_inputs(6, 16, 96, device="cpu", active_share=0.7, seed=1)
    active = args[7]
    p, pc = _plain_round_outputs(args)
    sens = checks.round_sensitivity(args)
    k = RoundResult(p.E, p.score, p.inliers)
    kc = RoundCandidates(*pc)
    a = int(torch.nonzero(active & (p.score < args[5]))[0, 0])   # an active pair that kept
    idle = int(torch.nonzero(~active)[0, 0])
    best = int(torch.argmin(pc[2][a]))
    if fault == "candidate":
        kc = kc._replace(E=kc.E.clone())
        kc.E[a] *= 1 + 1e-4
    elif fault == "score":
        kc = kc._replace(score=kc.score.clone())
        kc.score[a, best] *= 1 + 1e-6
    elif fault == "validity":
        kc = kc._replace(valid=kc.valid.clone())
        kc.valid[a, best] = False
    elif fault == "pick":       # the worst valid candidate taken
        worst = int(torch.argmax(torch.where(pc[1][a], pc[2][a], -1.0)))
        kc = kc._replace(score=kc.score.clone())
        kc.score[a, worst] = -1.0
    elif fault == "keep":       # an active pair that kept left as it was
        k = k._replace(E=k.E.clone(), score=k.score.clone(), inliers=k.inliers.clone())
        k.E[a], k.score[a], k.inliers[a] = args[4][a], args[5][a], args[6][a]
    elif fault == "inliers":
        k = k._replace(inliers=k.inliers.clone())
        k.inliers[a] = ~k.inliers[a] & args[3][a]
    elif fault == "inactive":
        k = k._replace(score=k.score.clone())
        k.score[idle] *= 0.5
    elif fault in ("root", "epipolar"):
        # scored as a kernel would score its own candidates; few enough
        # that the percentiles of the candidates' distances do not move
        rE = checks.candidate_residuals(args, pc[0])[1]
        root = checks.ROUND_ROOT_EPS * torch.finfo(torch.float64).eps
        ok = active[:, None] & pc[1] & (rE <= root)
        ok[torch.arange(6), torch.argmin(pc[2], -1)] = False
        picked = torch.nonzero(ok).tolist()
        E = kc.E.clone()
        if fault == "root":         # toward the next candidate of its triple
            for b, c in picked[:8]:
                other = 4 * (c // 4) + (c + 1) % 4
                E[b, c] += 1e-4 * (E[b, other] - E[b, c])
        else:                       # a solution of another pair's triple
            (b, c), src = picked[0], next(x for x in picked if x[0] != picked[0][0])
            E[b, c] = E[tuple(src)]
        kc = kc._replace(E=E, score=checks.candidate_scores(args, E, kc.valid))
    info, failures = checks.round_agreement(args, k, kc, p, pc, sens)
    if fault == "none":
        assert failures == [] and info["kept"] > 0 and info["active"] < 6
        assert info["E_gap_max"] == 0 and max(info["plain_move_quantiles"]) > 0
        assert info["roots_lost"] == info["witness_roots_lost"] == 0
        assert 0 < info["epipolar_max"] <= checks.ROUND_EPIPOLAR_EPS * 2.3e-16
    else:
        assert failures, info
    if fault == "root":
        assert any("lost" in f for f in failures), failures
    if fault == "epipolar":
        assert any("epipolar" in f for f in failures), failures
