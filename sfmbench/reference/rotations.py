"""The benchmark's plain reference of rotation averaging: the robust cost
the program minimises, and a Levenberg–Marquardt that minimises it with a
dense solve of the full normal equations.

Plain PyTorch, float64 unless a caller asks for another dtype; it imports
nothing of the program. The cost is that of the program's
`optim/pose_graph.py` (`pose_graph_cost`, `optimize_rotations`): with one
axis-angle vector r_n a node, R(r) = exp([r]×), and each live edge i → j
measuring R_e (x_j = R_e x_i),

    cost(r) = ½ Σ_e ρ(‖s · log(R(r_j) R(r_i)ᵀ R_eᵀ)‖²),
    ρ(x) = 2b(√(1 + x/b) − 1), b = 0.03²  (Ceres' SoftLOneLoss at 0.03),
    s = 1 / max_e ‖log R_e‖ over the live edges,

node 0 held where it starts (the gauge) and the others moved additively in
their axis-angle vectors, as the program moves them.

Departures from the program's minimiser (none from its cost):

* each edge's 3 × 6 Jacobian comes from forward-mode autograd of the
  closed forms below, and the blocks are added into one dense
  (3N − 3)² matrix JᵀWJ with node 0's rows and columns left out: no
  sorted segment sums, no CG, no masking of the gauge;
* the damped system (JᵀWJ + λ·diag(JᵀWJ)) dx = −JᵀW res is solved by a
  Cholesky factor of the whole matrix, without equilibration;
* the weights W are the loss's IRLS weights ρ'(‖res‖²), as in the program
  (no second-order correction of the loss);
* the damping starts at 1e-4, shrinks by 3 on a decrease and grows by 4
  otherwise (the program: ×0.33 and ×4); the loop stops at a relative
  decrease under `ftol`, at λ > 1e10 or after `max_iters` (200 by default,
  against the program's 64, so that it ends at a minimum).
"""

from __future__ import annotations

import torch

SOFT_L1_SCALE = 0.03


def _skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def so3_exp(r):
    """Rodrigues' formula, with its Taylor limits below θ² = 1e-12."""
    th2 = torch.sum(r * r, -1)[..., None, None]
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    K = _skew(r)
    return torch.eye(3, dtype=r.dtype, device=r.device) + a * K + b * (K @ K)


def so3_log(R):
    """The axis-angle vector of R, for angles below π: θ = atan2(‖v‖, c)
    with v = vee(R − Rᵀ)/2 = sin θ · axis and c = (tr R − 1)/2, scaled by
    θ / sin θ (its Taylor limit below sin² θ = 1e-12)."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    # kept (..., 1), never 0-d: a 0-d tensor times or plus a Python float
    # gives a float64 forward-mode derivative
    s2 = torch.sum(v * v, -1, keepdim=True)
    c = 0.5 * (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True) - 1.0)
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    k = torch.where(small, 1.0 + s2 / 6.0, torch.atan2(s, c) / s)
    return k * v


def soft_l1(x, scale: float = SOFT_L1_SCALE):
    """(ρ(x), ρ'(x)) of Ceres' SoftLOneLoss."""
    b = scale * scale
    root = torch.sqrt(1.0 + x / b)
    return 2.0 * b * (root - 1.0), 1.0 / root


def edge_scale(r_meas, live):
    """1 / the largest live measurement angle."""
    norms = torch.where(live, torch.linalg.norm(r_meas, dim=-1), torch.zeros_like(r_meas[:, 0]))
    return 1.0 / torch.clamp(norms.max(), min=1e-12)


def residuals(rot, edge_i, edge_j, r_meas, scale):
    """(E, 3) residuals s · log(R_j R_iᵀ R_eᵀ)."""
    Ri, Rj, Rm = so3_exp(rot[edge_i]), so3_exp(rot[edge_j]), so3_exp(r_meas)
    return scale * so3_log(Rj @ Ri.transpose(-1, -2) @ Rm.transpose(-1, -2))


def cost(rot, edge_i, edge_j, r_meas, edge_w):
    """The robust cost ½ Σ ρ(‖res‖²) over the live edges (edge_w > 0)."""
    live = edge_w > 0
    res = residuals(rot, edge_i, edge_j, r_meas, edge_scale(r_meas, live))
    rho, _ = soft_l1(torch.sum(res * res, -1))
    return 0.5 * torch.sum(torch.where(live, rho, torch.zeros_like(rho)))


def normal_equations(rot, edge_i, edge_j, r_meas, edge_w):
    """(H, g) over nodes 1..N−1: H = JᵀWJ as a dense (3N − 3)² matrix and
    g = JᵀW res, from each live edge's 3 × 6 Jacobian block."""
    live = edge_w > 0
    ei, ej, rm = edge_i[live], edge_j[live], r_meas[live]
    scale = edge_scale(r_meas, live)
    N, dt, dev = rot.shape[0], rot.dtype, rot.device

    def one(ri, rj, m):
        return scale * so3_log(so3_exp(rj) @ so3_exp(ri).T @ so3_exp(m).T)

    res = torch.func.vmap(one)(rot[ei], rot[ej], rm)                       # (E, 3)
    Ji, Jj = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1)))(rot[ei], rot[ej], rm)
    J = torch.cat([Ji, Jj], -1)                                            # (E, 3, 6)
    _, w = soft_l1(torch.sum(res * res, -1))
    blocks = torch.einsum("eki,ekj->eij", w[:, None, None] * J, J)         # (E, 6, 6)
    grads = torch.einsum("eki,ek->ei", w[:, None, None] * J, res)          # (E, 6)
    cols = torch.cat([3 * ei[:, None] + torch.arange(3, device=dev),
                      3 * ej[:, None] + torch.arange(3, device=dev)], -1)  # (E, 6)
    H = torch.zeros((3 * N, 3 * N), dtype=dt, device=dev)
    H.index_put_((cols[:, :, None].expand(-1, 6, 6).reshape(-1),
                  cols[:, None, :].expand(-1, 6, 6).reshape(-1)), blocks.reshape(-1),
                 accumulate=True)
    g = torch.zeros(3 * N, dtype=dt, device=dev)
    g.index_put_((cols.reshape(-1),), grads.reshape(-1), accumulate=True)
    return H[3:, 3:], g[3:]


def optimize_rotations(rot0, edge_i, edge_j, r_meas, edge_w, max_iters: int = 200,
                       ftol: float = 1e-12) -> dict:
    """Minimise `cost` from rot0 (N, 3), node 0 held. Returns {rotations
    (N, 3), cost, initial_cost, iterations}, in the inputs' dtype."""
    rot = rot0.clone()
    edge_i, edge_j = edge_i.long(), edge_j.long()
    c = c0 = cost(rot, edge_i, edge_j, r_meas, edge_w)
    lam, it = 1e-4, 0
    while it < max_iters:
        it += 1
        H, g = normal_equations(rot, edge_i, edge_j, r_meas, edge_w)
        d = torch.clamp(torch.diagonal(H), min=1e-12)
        L, info = torch.linalg.cholesky_ex(H + torch.diag(lam * d))
        if int(info) != 0:
            lam *= 4.0
            if lam > 1e10:
                break
            continue
        dx = torch.cholesky_solve(-g[:, None], L)[:, 0]
        trial = rot.clone()
        trial[1:] = rot[1:] + dx.reshape(-1, 3)
        c_new = cost(trial, edge_i, edge_j, r_meas, edge_w)
        if torch.isfinite(c_new) and c_new < c:
            rel = float((c - c_new) / torch.clamp(c, min=1e-300))
            rot, c = trial, c_new
            lam = max(lam / 3.0, 1e-12)
            if rel < ftol:
                break
        else:
            lam *= 4.0
            if lam > 1e10:
                break
    return dict(rotations=rot, cost=c, initial_cost=c0, iterations=it)
