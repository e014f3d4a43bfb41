"""The RANSAC round kernel (`csrc/spherical_round.cu`) against the plain
PyTorch round (`ransac/spherical.py::_round_plain`) run on the same CUDA
tensors: the main path's chunk of 128 pairs × 128 triples × 1024 matches,
chunk edges, degenerate triples, rows past shared memory, float32, a
bit-for-bit repeat, the adaptive engine's rounds and launches, and the
wrapper's checks. Every test needs an NVIDIA GPU (marker `cuda`) and skips
without one. The module imports no JAX, so on the GPU machine it runs
without the repository's conftest:

    python -m pytest tests/test_torch_cuda_round.py -m cuda --noconftest -q

What must agree, and why (`kernel_checks.round_agreement`, the smoke's):
* Each triple with as many valid candidates, and the plain candidates
  matched to the nearest kernel candidate of their triple (rounding may
  hand the roots to the slots in another order): at the 50th to 99.9th
  percentiles no farther than 10× what the plain solve itself moves when
  its rays move by one rounding (`kernel_checks.round_sensitivity`). The
  solve forms normal equations whose condition number reaches 1e18 on
  some triples, has near-double roots, and takes spurious candidates from
  complex pairs' real parts: the plain solve moves by up to ~1 there on
  the card, so no second implementation can match every candidate to
  1e-9.
* Candidate by candidate, whatever the conditioning, with the plain solve
  on the CPU as a witness of what rounding alone moves: every valid
  candidate within 2^14 ε of its own triple's three epipolar constraints;
  the plain solutions (essential-matrix residual at most 2^19 ε) whose
  nearest kernel candidate is none, and the reverse, each at most 3× the
  witness's count and 5; the candidates farther than 10× the plain
  solve's own move, at most 4× the witness's count and 10.
* Every candidate's MSAC score within 1e-9 relative (or 1e-12 of a capped
  match) of the plain scoring of the kernel's own E: a score moves with E
  at up to 1/|vᵀEu| of its inliers, so it is held to its own candidate's.
* The best candidate, except where the plain round's two lowest scores lie
  within 1e-9 relative; the keep, except there or where the best scores
  within 1e-9 relative of the running best; kept models within 1e-9 and
  inlier rows alike (off the threshold); every pair that did not keep,
  and every inactive pair, left bit for bit as it was.
"""

import pytest
import torch

from sphericalsfm_tpu_torch.eval import kernel_checks as checks
from sphericalsfm_tpu_torch.ransac import spherical as sph
from sphericalsfm_tpu_torch.ransac.round_kernel import spherical_round

SQ = (2.0 / 600) ** 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the round kernel has no CPU mode")
    return torch.device("cuda")


def _both(args):
    """The kernel (with its candidates) and the plain round on `args`."""
    triples, u, v, mask, E, score, inliers, active, sq = args
    before = spherical_round.launches
    k, kc = spherical_round(*args, candidates=True)
    p = sph._round_plain(sph._Part(u, v, mask, E, score, inliers), triples, active, sq)
    torch.cuda.synchronize()
    assert spherical_round.launches == before + 1
    return k, kc, p


def _check(args):
    k, kc, p = _both(args)
    pc = checks.round_plain_candidates(args)
    info, failures = checks.round_agreement(args, k, kc, p, pc, checks.round_sensitivity(args))
    assert not failures, (failures, info)
    return k, p, info


@pytest.mark.cuda
def test_round_kernel_matches_plain_round_at_the_main_chunk(cuda):
    args = checks.round_inputs(128, 128, 1024, device=cuda)
    k, p, info = _check(args)
    assert info["kept"] > 10 and info["active"] < 128


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 127, 129])
def test_round_kernel_chunk_edges(cuda, B):
    args = checks.round_inputs(B, 128, 1024, seed=B, device=cuda, active_share=0.9)
    _check(args)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 100, 300])
def test_round_kernel_triples_past_one_tile(cuda, R):
    """R triples in tiles of 128: a partial tile, and three tiles whose
    best is taken in order."""
    _check(checks.round_inputs(16, R, 512, seed=R, device=cuda, active_share=1.0))


@pytest.mark.cuda
def test_round_kernel_rows_past_shared_memory(cuda):
    """5000 matches in float64 (240 KB a pair) do not fit the staged rows:
    they are read from device memory, the mask tested per row."""
    _check(checks.round_inputs(6, 128, 5000, seed=9, device=cuda, active_share=1.0))


@pytest.mark.cuda
def test_round_kernel_degenerate_triples(cuda):
    """Pair 0 samples one row three times, pair 1 a row twice, pair 2
    three copies of one correspondence at different rows: their rows span
    less than three dimensions, so both solves complete the nullspace from
    rounding noise and only the kernel's consistency with its own
    candidates is held there. Pair 3 samples masked rows that hold NaN,
    pair 4 has no valid row and pair 5 two; pairs 6 and 7 are ordinary:
    these are held to the plain round in full."""
    from sphericalsfm_tpu_torch.ransac.round_kernel import RoundCandidates, RoundResult

    triples, u, v, mask, E, score, inliers, active, sq = checks.round_inputs(
        8, 64, 256, seed=11, device=cuda, active_share=1.0)
    first = torch.nonzero(mask[0])[:, 0]
    triples[0] = first[0]
    triples[1, :, 1] = triples[1, :, 0]
    rows = torch.nonzero(mask[2])[:3, 0]
    u[2, rows] = u[2, rows[0]].clone()
    v[2, rows] = v[2, rows[0]].clone()
    triples[2, :5] = rows
    mask[3, 200:] = False
    u[3, 200:] = float("nan")
    v[3, 200:] = float("nan")
    triples[3, :8] = torch.tensor([200, 201, 202], device=cuda)
    mask[4] = False
    inliers[4] = False
    mask[5] = False
    mask[5, :2] = True
    inliers[5] &= mask[5]
    args = (triples, u, v, mask, E, score, inliers, active, sq)
    k, kc, p = _both(args)
    assert torch.isfinite(k.E).all() and torch.isfinite(k.score).all()
    assert not k.inliers[4].any() and not (k.inliers[5] & ~mask[5]).any()
    assert not kc.valid[3, :32].any()                      # the NaN rows' triples
    ik = torch.argmin(kc.score, -1)
    kept = k.score < score
    own = kc.E[torch.arange(8, device=cuda), ik]
    assert torch.equal(k.E[kept], own[kept])
    assert torch.equal(k.E[~kept], E[~kept]) and torch.equal(k.inliers[~kept], inliers[~kept])
    held = torch.arange(3, 8, device=cuda)
    sub = tuple(x[held] if torch.is_tensor(x) else x for x in args)
    info, failures = checks.round_agreement(
        sub, RoundResult(*(x[held] for x in k)), RoundCandidates(*(x[held] for x in kc)),
        sph._Part(*(x[held] for x in p)), checks.round_plain_candidates(sub),
        checks.round_sensitivity(sub))
    assert not failures, (failures, info)


@pytest.mark.cuda
def test_round_kernel_float32_within_its_rounding(cuda):
    """float32: the float64 chunk's problems. Rounding is 1.2e-7, and the
    normal equations of the solve square the condition of its 10×6 system,
    so the candidates differ at ~1e-7 × cond and the picks among
    near-equal candidates may too: the kernel is held to the plain round's
    keep on nine pairs in ten, each candidate's score to the plain scoring
    of its own E within 1e-4 relative (a sum of up to 1024 float32 terms in
    another order) or a thousandth of a capped match, and the pairs it did
    not keep bit for bit."""
    args = checks.round_inputs(128, 128, 1024, dtype=torch.float32, device=cuda)
    triples, u, v, mask, E, score, inliers, active, sq = args
    k, kc, p = _both(args)
    kept_k, kept_p = active & (k.score < score), active & (p.score < score)
    assert (kept_k == kept_p).double().mean() >= 0.9
    errs = sph.sampson_error(kc.E, u[:, None], v[:, None])
    errs = torch.where(torch.isfinite(errs), errs, torch.full_like(errs, float("inf")))
    own = torch.where(kc.valid, torch.where(mask[:, None], errs.clamp(max=sq), 0).sum(-1),
                      float("inf"))
    act = active[:, None] & kc.valid
    torch.testing.assert_close(kc.score[act], own[act], rtol=1e-4, atol=1e-3 * sq)
    left = ~kept_k
    assert torch.equal(k.E[left], E[left]) and torch.equal(k.score[left], score[left])
    assert torch.equal(k.inliers[left], inliers[left])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_round_kernel_repeats_bit_for_bit(cuda, dtype):
    args = checks.round_inputs(64, 128, 1024, dtype=dtype, seed=3, device=cuda)
    a, ac = spherical_round(*args, candidates=True)
    b, bc = spherical_round(*args, candidates=True)
    for x, y in zip(a + ac, b + bc):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def _chunk(cuda, B=128, N=1024, seed=0):
    """A pairwise chunk: random problems with 20–60% outliers."""
    r = checks.round_inputs(B, 1, N, seed=seed, device=cuda, outliers=(0.2, 0.6),
                            rotation_deg=10.0)
    return r[1], r[2], r[3]


@pytest.mark.cuda
def test_adaptive_rounds_match_the_plain_round(cuda, monkeypatch):
    """The adaptive engine on a 128-pair chunk from one generator seed, its
    rounds through the kernel and through the plain round: the same rounds
    a pair on 99% of pairs and the same rounds a chunk; the kernel launched
    once a round."""
    u, v, mask = _chunk(cuda)
    gen = torch.Generator(device=cuda)
    before = spherical_round.launches
    k = sph.spherical_ransac_adaptive(gen.manual_seed(5), u, v, mask, SQ,
                                      final_least_squares=False, lo_rounds=0)
    launches = spherical_round.launches - before
    monkeypatch.setattr(sph, "_round", sph._round_plain)
    p = sph.spherical_ransac_adaptive(gen.manual_seed(5), u, v, mask, SQ,
                                      final_least_squares=False, lo_rounds=0)
    assert launches == int(k.rounds.max()) >= 2
    assert int(k.rounds.max()) == int(p.rounds.max())
    assert (k.rounds == p.rounds).double().mean() >= 0.99
    same = (k.num_inliers == p.num_inliers).double().mean()
    assert same >= 0.95, same


@pytest.mark.cuda
def test_sharded_rounds_launch_once_a_part(cuda):
    """Two parts on the card (a mesh's rows split in two): the adaptive
    engine launches the kernel rounds × 2 times and the static one once a
    part, each on its part's rows, with the one-part result bit for bit
    (without the LO refits, whose batched products take another kernel at
    another batch, ROADMAP C27)."""
    u, v, mask = _chunk(cuda, B=40, N=512, seed=1)
    gen = torch.Generator(device=cuda)
    for engine in ("adaptive", "static"):
        def run(devices):
            g = gen.manual_seed(2)
            if engine == "adaptive":
                return sph.spherical_ransac_adaptive(g, u, v, mask, SQ, lo_rounds=0,
                                                     devices=devices)
            return sph.spherical_ransac(g, u, v, mask, SQ, num_hypotheses=512, devices=devices)

        one = run(None)
        before = spherical_round.launches
        two = run([cuda, cuda])
        launches = spherical_round.launches - before
        assert launches == (2 * int(two.rounds.max()) if engine == "adaptive" else 2)
        for x, y in zip(one, two):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_round_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = list(checks.round_inputs(4, 8, 64, device=cuda))
    triples, u, v = args[:3]
    with pytest.raises(ValueError, match="contiguous"):
        spherical_round(triples, u.transpose(0, 1).contiguous().transpose(0, 1), *args[2:])
    with pytest.raises(ValueError, match="is on cpu"):
        spherical_round(triples, u, v.cpu(), *args[3:])
    with pytest.raises(ValueError, match="float32 or float64"):
        spherical_round(*(x.half() if torch.is_tensor(x) and x.is_floating_point() else x
                          for x in args))
    with pytest.raises(ValueError, match="must be"):
        spherical_round(triples.int(), *args[1:])
    with pytest.raises(ValueError, match="must be"):
        spherical_round(*args[:7], args[7].to(torch.uint8), args[8])
