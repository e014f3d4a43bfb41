"""Batched dense Levenberg–Marquardt for small parameter vectors — port of
`sphericalsfm_tpu/optim/lm.py`.

The JAX version runs one `lax.while_loop` per problem under `vmap`. Here a
batch of independent problems runs in one Python loop: every iteration
computes all of them and masks the updates of problems that have already
finished, which is what `while_loop` under `vmap` does. Jacobians come
from `torch.func.jacfwd` of the per-problem residual.

Robust losses follow Ceres: given squared residual s, rho(s) is the cost
and the IRLS weight is rho'(s).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def cauchy_weight(s, scale: float = 1.0):
    """rho(s) = c²·log(1 + s/c²); weight rho'(s) = 1/(1 + s/c²)."""
    return 1.0 / (1.0 + s / (scale * scale))


def cauchy_rho(s, scale: float = 1.0):
    c2 = scale * scale
    return c2 * torch.log1p(s / c2)


def soft_l1_weight(s, scale: float = 1.0):
    """Ceres SoftLOneLoss: rho(s) = 2b(sqrt(1 + s/b) − 1), b = scale²."""
    return 1.0 / torch.sqrt(1.0 + s / (scale * scale))


def soft_l1_rho(s, scale: float = 1.0):
    b = scale * scale
    return 2.0 * b * (torch.sqrt(1.0 + s / b) - 1.0)


def trivial_weight(s, scale: float = 1.0):
    return torch.ones_like(s)


def trivial_rho(s, scale: float = 1.0):
    return s


class LMResult(NamedTuple):
    x: torch.Tensor           # (B, P)
    cost: torch.Tensor        # (B,)
    iterations: torch.Tensor  # (B,)
    converged: torch.Tensor   # (B,)


def levenberg_marquardt(
    residual_fn: Callable[..., torch.Tensor],
    x0: torch.Tensor,
    args: tuple = (),
    mask: torch.Tensor | None = None,
    max_iters: int = 50,
    init_lambda: float = 1e-4,
    rho=trivial_rho,
    weight=trivial_weight,
    ftol: float = 1e-10,
    xtol: float = 1e-14,
) -> LMResult:
    """Minimize 0.5·Σ_i m_i·rho(‖r_i‖²) for a batch of problems.

    x0 (B, P); `residual_fn(x (P,), *args_b)` returns ONE problem's residual
    blocks (N, D) or (N,) — args are batched along dim 0 and mapped with
    `torch.func.vmap`. `mask` (B, N) weights the blocks.
    """
    def blocks(x, *a):
        r = residual_fn(x, *a)
        return r[:, None] if r.ndim == 1 else r.reshape(-1, r.shape[-1])

    F = torch.func.vmap(blocks)
    JF = torch.func.vmap(torch.func.jacfwd(blocks))
    B = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    n_blocks = F(x0, *args).shape[1]
    m = torch.ones((B, n_blocks), dtype=dtype, device=dev) if mask is None \
        else mask.reshape(B, -1).to(dtype)

    def total_cost(x):
        r = F(x, *args)
        return 0.5 * torch.sum(m * rho(torch.sum(r * r, dim=-1)), dim=-1)

    x = x0
    cost = total_cost(x0)
    lam = torch.full((B,), init_lambda, dtype=dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        active = ~done
        r = F(x, *args)                                   # (B, N, D)
        J = JF(x, *args)                                  # (B, N, D, P)
        w = weight(torch.sum(r * r, dim=-1)) * m          # (B, N)
        Jw = J * w[..., None, None]
        JtJ = torch.einsum("bndp,bndq->bpq", Jw, J)
        Jtr = torch.einsum("bndp,bnd->bp", Jw, r)
        damp = torch.diag_embed(torch.clamp(torch.diagonal(JtJ, dim1=-2, dim2=-1), min=1e-12))
        dx, _ = torch.linalg.solve_ex(JtJ + lam[:, None, None] * damp, -Jtr)
        x_new = x + dx
        cost_new = total_cost(x_new)
        bad = (~torch.isfinite(cost_new)) | (cost_new > cost)
        lam_n = torch.where(bad, lam * 10.0, torch.clamp(lam * 0.3, min=1e-12))
        x_n = torch.where(bad[:, None], x, x_new)
        cost_n = torch.where(bad, cost, cost_new)
        rel = (cost - cost_n) / torch.clamp(cost, min=1e-30)
        step_small = torch.linalg.norm(dx, dim=-1) < xtol * (torch.linalg.norm(x_n, dim=-1) + xtol)
        stop = ((~bad) & (rel < ftol)) | step_small | (lam_n > 1e10)
        x = torch.where(active[:, None], x_n, x)
        lam = torch.where(active, lam_n, lam)
        cost = torch.where(active, cost_n, cost)
        iters = iters + active.to(torch.int64)
        done = done | (active & stop)
    return LMResult(x=x, cost=cost, iterations=iters, converged=done)
