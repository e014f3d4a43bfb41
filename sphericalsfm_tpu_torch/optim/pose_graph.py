"""Rotation averaging and the uncalibrated spherical pose graph — port of
`sphericalsfm_tpu/optim/pose_graph.py`.

Per-camera axis-angle rotations, cycle residual scale·log(R₁R₀ᵀR_measᵀ)
with scale = 1/max‖log R_meas‖, SoftL1(0.03) loss, first camera fixed.
Each LM iteration takes per-edge Jacobian blocks from `torch.func.jacfwd`,
assembles the dense (3N [+1])² normal equations with `index_add_`, and
solves by an equilibrated Cholesky. The uncalibrated graph adds one scalar
parameter, the focal multiplier f: each measurement splits into an in-plane
axis rotation Rxy(θxy) and a roll Rz(θz), and θxy warps as
θ' = atan2(2f·sinθxy, (1+f²)cosθxy + (1−f²)), f bound-constrained.
Above 400 frames ("auto") the LM step is matrix-free instead: block-Jacobi
preconditioned CG over the edge list, the node reductions by `index_add_`.

The focal sweep runs every hypothesis at once: the relative rotations at T
focal hypotheses are a (T, E, 3) batch, the rotation init composes a
(T, N, 3, 3) batch along one spanning tree (pointer doubling; the
sequential chain is the tree whose parent is the previous frame), and the
cost reduces over the edge axis. Hypotheses go in chunks of at most
`SWEEP_BATCH` hypothesis-edges.
"""

from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.essential import conjugate_essential_by_focal, decompose_spherical_essential
from ..geometry.so3 import so3_exp, so3_log
from .ba import _jacobi_factor
from .lm import soft_l1_rho, soft_l1_weight

SOFT_L1_SCALE = 0.03
SWEEP_BATCH = 1 << 18  # hypothesis × edge rows per focal-sweep batch


class RotationGraph(NamedTuple):
    """Edge list of relative-rotation measurements i -> j (i < j)."""

    edge_i: torch.Tensor   # (E,) int64
    edge_j: torch.Tensor   # (E,)
    r_meas: torch.Tensor   # (..., E, 3) axis-angle of R_ij (x_j = R_ij x_i)
    edge_w: torch.Tensor   # (E,) weight (0 = unused)


def _edge_scale(g: RotationGraph) -> torch.Tensor:
    """1 / max‖log R_meas‖ over live edges, per leading batch index."""
    norms = torch.linalg.norm(g.r_meas, dim=-1)
    norms = torch.where(g.edge_w > 0, norms, torch.zeros_like(norms))
    return 1.0 / torch.clamp(norms.amax(dim=-1), min=1e-12)


def _cycle_residual(r0, r1, r_meas, scale):
    """scale · log(R₁ R₀ᵀ R_measᵀ), batched over leading axes."""
    R0, R1, Rm = so3_exp(r0), so3_exp(r1), so3_exp(r_meas)
    return scale * so3_log((R1 @ R0.transpose(-1, -2)) @ Rm.transpose(-1, -2))


def pose_graph_cost(rotations_r: torch.Tensor, g: RotationGraph) -> torch.Tensor:
    """0.5·Σ ρ_softL1(‖res‖²) at fixed rotations; rotations (..., N, 3) and
    g.r_meas (..., E, 3) may carry the same leading batch axes."""
    res = _cycle_residual(rotations_r[..., g.edge_i, :], rotations_r[..., g.edge_j, :],
                          g.r_meas, _edge_scale(g)[..., None, None])
    rho = soft_l1_rho(torch.sum(res * res, dim=-1), SOFT_L1_SCALE)
    return 0.5 * torch.sum(torch.where(g.edge_w > 0, rho, torch.zeros_like(rho)), dim=-1)


def decompose_rotation_xy_z(R: torch.Tensor):
    """Split R = Rxy ∘ Rz: a rotation about an axis in the xy-plane, then a
    roll about z. Returns (rx, ry, thetaxy, thetaz), batched."""
    Z = R[..., :, 2]
    Z = Z / torch.linalg.norm(Z, dim=-1, keepdim=True)
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=R.dtype, device=R.device).expand_as(Z)
    axis = torch.linalg.cross(e3, Z, dim=-1)
    axis_n = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.where(axis_n > 1e-12, axis_n, torch.ones_like(axis_n))
    thetaxy = torch.acos(torch.clamp(Z[..., 2], -1.0, 1.0))
    Rxy = so3_exp(thetaxy[..., None] * axis)
    thetaz = so3_log(Rxy.transpose(-1, -2) @ R)[..., 2]
    return axis[..., 0], axis[..., 1], thetaxy, thetaz


def warp_thetaxy(thetaxy, focal_mult):
    """θ'xy(f): the in-plane rotation angle after rescaling the focal by f."""
    f2 = focal_mult * focal_mult
    num = 2.0 * focal_mult * torch.sin(thetaxy)
    den = (1.0 + f2) * torch.cos(thetaxy) + (1.0 - f2)
    return torch.atan2(num, den)


def _warped_measurement(rx, ry, thetaxy, thetaz, focal_mult):
    """R_meas(f) = Rxy(θ'xy(f)) · Rz(θz), batched."""
    txy = warp_thetaxy(thetaxy, focal_mult)
    zeros = torch.zeros_like(txy)
    rxy = torch.stack([txy * rx, txy * ry, zeros], dim=-1)
    rz = torch.stack([zeros, zeros, zeros + thetaz], dim=-1)
    return so3_exp(rxy) @ so3_exp(rz)


def _robust_block_lm(residual_edge, rotations_r, extra0, edge_i, edge_j, edge_data,
                     edge_w, fixed_mask, extra_bounds=None, max_iters: int = 64,
                     ftol: float = 1e-12, solver: str = "dense", pcg_iters: int = 128,
                     pcg_rtol: float = 1e-8):
    """Robust LM over rotations and an optional scalar `extra` parameter
    (the focal multiplier), clipped to `extra_bounds` after each step.
    `residual_edge(r0, r1, extra, data)` maps edge-batched inputs to (E, 3)
    residuals. solver="dense" solves the (3N [+1])² normal equations by an
    equilibrated Cholesky; "pcg" runs block-Jacobi CG over the edge list
    without forming them (one host sync per CG iteration). Both share the
    step control. Returns (rotations, extra, cost)."""
    N = rotations_r.shape[0]
    dtype, dev = rotations_r.dtype, rotations_r.device
    has_extra = extra0 is not None
    D = 3 * N + (1 if has_extra else 0)
    ei, ej = edge_i.long(), edge_j.long()
    E = ei.shape[0]
    live = edge_w > 0
    free = (~fixed_mask).to(dtype)

    def edge_res(packed, data):
        return residual_edge(packed[:3], packed[3:6], packed[6] if has_extra else None, data)

    jac = torch.func.vmap(torch.func.jacfwd(edge_res))

    def total_cost(rots, extra):
        res = residual_edge(rots[ei], rots[ej], extra, edge_data)
        rho = soft_l1_rho(torch.sum(res * res, dim=-1), SOFT_L1_SCALE)
        return 0.5 * torch.sum(torch.where(live, rho, torch.zeros_like(rho)))

    def node_sum(x0, x1):
        out = torch.zeros((N,) + x0.shape[1:], dtype=dtype, device=dev)
        return out.index_add_(0, ei, x0).index_add_(0, ej, x1)

    def edge_terms(rots, extra):
        """Weighted edge blocks A0 = J0ᵀwJ0, A1, C01 = J0ᵀwJ1, gradients
        g0, g1, focal columns f0, f1 and the focal's Hff, gf."""
        parts = [rots[ei], rots[ej]] + ([extra.expand(E)[:, None]] if has_extra else [])
        res = residual_edge(rots[ei], rots[ej], extra, edge_data)
        J = jac(torch.cat(parts, dim=-1), edge_data)              # (E, 3, 6[+1])
        w = soft_l1_weight(torch.sum(res * res, dim=-1), SOFT_L1_SCALE) * live
        J0w = J[:, :, :3] * free[ei][:, None, None] * w[:, None, None]
        J1 = J[:, :, 3:6] * free[ej][:, None, None]
        J1w = J1 * w[:, None, None]
        A0 = torch.einsum("edi,edj->eij", J0w, J[:, :, :3] * free[ei][:, None, None])
        A1 = torch.einsum("edi,edj->eij", J1w, J1)
        C01 = torch.einsum("edi,edj->eij", J0w, J1)
        g0 = torch.einsum("edi,ed->ei", J0w, res)
        g1 = torch.einsum("edi,ed->ei", J1w, res)
        if not has_extra:
            zero = torch.zeros((), dtype=dtype, device=dev)
            return A0, A1, C01, g0, g1, torch.zeros_like(g0), torch.zeros_like(g1), zero, zero
        Jf = J[:, :, 6]
        return (A0, A1, C01, g0, g1, torch.einsum("edi,ed->ei", J0w, Jf),
                torch.einsum("edi,ed->ei", J1w, Jf), torch.sum(w * torch.sum(Jf * Jf, dim=-1)),
                torch.sum(w * torch.sum(Jf * res, dim=-1)))

    def dense_step(rots, extra, lam):
        A0, A1, C01, g0, g1, f0, f1, Hff, gf = edge_terms(rots, extra)
        H = torch.zeros((N * N, 3, 3), dtype=dtype, device=dev)
        H.index_add_(0, ei * N + ej, C01)
        H = H.reshape(N, N, 3, 3)
        H = H + H.permute(1, 0, 3, 2)
        ar = torch.arange(N, device=dev)
        H[ar, ar] += node_sum(A0, A1)
        Hfull = torch.zeros((D, D), dtype=dtype, device=dev)
        Hfull[:3 * N, :3 * N] = H.permute(0, 2, 1, 3).reshape(3 * N, 3 * N)
        gvec = node_sum(g0, g1).reshape(3 * N)
        if has_extra:
            fcol = node_sum(f0, f1).reshape(3 * N)
            Hfull[:3 * N, 3 * N] = Hfull[3 * N, :3 * N] = fcol
            Hfull[3 * N, 3 * N] = Hff
            gvec = torch.cat([gvec, gf[None]])
        diag = torch.clamp(torch.diagonal(Hfull), min=1e-12)
        A = Hfull + torch.diag(lam * diag)
        dscale = torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-15))
        A_eq = A / dscale[:, None] / dscale[None, :]
        L, _ = torch.linalg.cholesky_ex(A_eq + 1e-12 * torch.eye(D, dtype=dtype, device=dev))
        dx = torch.cholesky_solve((-(gvec / dscale))[:, None], L)[:, 0] / dscale
        return dx[:3 * N].reshape(N, 3), dx[3 * N] if has_extra else None

    def pcg_step(rots, extra, lam):
        A0, A1, C01, g0, g1, f0, f1, Hff, gf = edge_terms(rots, extra)
        # frozen (gauge) nodes are exact zeros after the node reduction
        Hnn = node_sum(A0, A1) * free[:, None, None]
        gnode = node_sum(g0, g1) * free[:, None]
        dvec = torch.clamp(torch.diagonal(Hnn, dim1=-2, dim2=-1), min=1e-12)
        Hff_d = Hff * (1.0 + lam) + 1e-12

        def matvec(x, xf):
            xi, xj = x[ei], x[ej]
            y0 = torch.einsum("eij,ej->ei", A0, xi) + torch.einsum("eij,ej->ei", C01, xj) + f0 * xf
            y1 = torch.einsum("eij,ei->ej", C01, xi) + torch.einsum("eij,ej->ei", A1, xj) + f1 * xf
            out = node_sum(y0, y1) * free[:, None] + lam * dvec * x
            return out, torch.sum(f0 * xi) + torch.sum(f1 * xj) + Hff_d * xf

        # damped node blocks, eps-clamped; a failed factor takes the
        # blocks' diagonal
        Pn = Hnn + torch.diag_embed(lam * dvec)
        Lp = _jacobi_factor(Pn, torch.diag_embed(torch.diagonal(Pn, dim1=-2, dim2=-1)), 1e-8)
        Pf = torch.clamp(Hff_d, min=1e-30)

        def precond(r, rf):
            return torch.cholesky_solve(r[:, :, None], Lp)[:, :, 0] * free[:, None], rf / Pf

        r, rf = -gnode, -gf
        thresh = pcg_rtol * pcg_rtol * torch.clamp(torch.sum(r * r) + rf * rf, min=1e-30)
        x, xf = torch.zeros_like(r), torch.zeros_like(rf)
        z, zf = precond(r, rf)
        p, pf = z, zf
        rz = torch.sum(r * z) + rf * zf
        it = 0
        while it < pcg_iters and bool((torch.sum(r * r) + rf * rf > thresh) & torch.isfinite(rz)):
            Ap, Apf = matvec(p, pf)
            denom = torch.sum(p * Ap) + pf * Apf
            alpha = rz / torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
            x, xf = x + alpha * p, xf + alpha * pf
            r, rf = r - alpha * Ap, rf - alpha * Apf
            z, zf = precond(r, rf)
            rz_new = torch.sum(r * z) + rf * zf
            beta = rz_new / torch.where(torch.abs(rz) > 1e-30, rz, 1e-30)
            p, pf = z + beta * p, zf + beta * pf
            rz = rz_new
            it += 1
        return x, xf if has_extra else None

    step = pcg_step if solver == "pcg" else dense_step
    rots = rotations_r
    extra = torch.as_tensor(extra0, dtype=dtype, device=dev) if has_extra else None
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    cost = total_cost(rots, extra)
    for _ in range(max_iters):
        dxn, dxf = step(rots, extra, lam)
        rots_n = rots + dxn * free[:, None]
        extra_n = extra
        if has_extra:
            extra_n = extra + dxf
            if extra_bounds is not None:
                extra_n = torch.clamp(extra_n, float(extra_bounds[0]), float(extra_bounds[1]))
        cost_n = total_cost(rots_n, extra_n)
        ok = bool(torch.isfinite(cost_n) & (cost_n < cost))
        rel = float((cost - cost_n) / torch.clamp(cost, min=1e-30))
        if ok:
            lam = torch.clamp(lam * 0.33, min=1e-12)
            rots, extra, cost = rots_n, extra_n, cost_n
        else:
            lam = lam * 4.0
        if (ok and rel < ftol) or float(lam) > 1e10:
            break
    return rots, extra, cost


def _gauge_mask(N: int, device) -> torch.Tensor:
    fixed = torch.zeros(N, dtype=torch.bool, device=device)
    fixed[0] = True
    return fixed


def _resolve_solver(solver: str, N: int) -> str:
    """"auto" is the PCG above 400 nodes (the real count), else dense."""
    if solver not in ("auto", "dense", "pcg"):
        raise ValueError(f"unknown pose-graph solver {solver!r}")
    return ("pcg" if N > 400 else "dense") if solver == "auto" else solver


def optimize_rotations(rotations_r: torch.Tensor, g: RotationGraph, max_iters: int = 64,
                       solver: str = "auto", ftol: float = 1e-12):
    """Robust rotation averaging; camera 0 is the gauge anchor. `solver`:
    "dense", "pcg" or "auto". Returns (rotations (N, 3), final cost);
    `optimize_rotations.solves` counts the calls by resolved solver."""
    solver = _resolve_solver(solver, rotations_r.shape[0])
    optimize_rotations.solves[solver] += 1
    scale = _edge_scale(g)

    def residual(r0, r1, _extra, r_meas):
        return _cycle_residual(r0, r1, r_meas, scale)

    rots, _, cost = _robust_block_lm(
        residual, rotations_r, None, g.edge_i, g.edge_j, g.r_meas, g.edge_w,
        _gauge_mask(rotations_r.shape[0], rotations_r.device), max_iters=max_iters, ftol=ftol,
        solver=solver)
    return rots, cost


def optimize_rotations_and_focal(rotations_r: torch.Tensor, g: RotationGraph, focal_mult0,
                                 mult_lo, mult_hi, max_iters: int = 64, solver: str = "auto"):
    """Joint rotations + focal-multiplier optimization, the multiplier held
    in [mult_lo, mult_hi]. Returns (rotations (N, 3), focal_mult, cost);
    the caller multiplies its focal by focal_mult."""
    solver = _resolve_solver(solver, rotations_r.shape[0])
    scale = _edge_scale(g)
    rx, ry, txy, tz = decompose_rotation_xy_z(so3_exp(g.r_meas))
    edge_data = torch.stack([rx, ry, txy, tz], dim=-1)

    def residual(r0, r1, fmult, data):
        Rm = _warped_measurement(data[..., 0], data[..., 1], data[..., 2], data[..., 3], fmult)
        R0, R1 = so3_exp(r0), so3_exp(r1)
        return scale * so3_log((R1 @ R0.transpose(-1, -2)) @ Rm.transpose(-1, -2))

    return _robust_block_lm(
        residual, rotations_r, focal_mult0, g.edge_i, g.edge_j, edge_data, g.edge_w,
        _gauge_mask(rotations_r.shape[0], rotations_r.device),
        extra_bounds=(mult_lo, mult_hi), max_iters=max_iters, solver=solver)


optimize_rotations.solves = {"dense": 0, "pcg": 0}


def _sequential_tree(num_frames: int, edge_i, edge_j, edge_w):
    """The adjacent-pair chain as a tree for `initialize_rotations_tree`:
    parent j−1, the live j−1→j edge, identity where that link is missing."""
    ei, ej = np.asarray(edge_i), np.asarray(edge_j)
    adj = np.nonzero((ej == ei + 1) & (np.asarray(edge_w) > 0))[0]
    parent = np.maximum(np.arange(num_frames) - 1, 0).astype(np.int32)
    eidx = np.zeros(num_frames, np.int32)
    sign = np.zeros(num_frames, np.int32)
    eidx[ej[adj]] = adj
    sign[ej[adj]] = 1
    return parent, eidx, sign


def initialize_rotations_sequential(num_frames: int, g: RotationGraph) -> torch.Tensor:
    """Chain adjacent relative rotations (missing links are identity)."""
    return initialize_rotations_tree(num_frames, g, *_sequential_tree(
        num_frames, g.edge_i.cpu().numpy(), g.edge_j.cpu().numpy(), g.edge_w.cpu().numpy()))


def build_spanning_tree(num_frames: int, edge_i, edge_j, edge_w):
    """Maximum-weight spanning forest (numpy), rooted at each component's
    smallest frame. Returns (parent, edge_idx, sign) int32: sign +1 if the
    tree edge is stored parent→child, −1 if reversed, 0 at roots."""
    ei = np.asarray(edge_i)
    ej = np.asarray(edge_j)
    w = np.asarray(edge_w, float)
    order = np.argsort(-w, kind="stable")
    uf = np.arange(num_frames)

    def find(x):
        while uf[x] != x:
            uf[x] = uf[uf[x]]
            x = uf[x]
        return x

    adj = [[] for _ in range(num_frames)]
    for e in order:
        if w[e] <= 0:
            continue
        a, b = find(ei[e]), find(ej[e])
        if a != b:
            uf[a] = b
            adj[ei[e]].append((int(ej[e]), int(e)))
            adj[ej[e]].append((int(ei[e]), int(e)))

    parent = np.arange(num_frames, dtype=np.int32)
    eidx = np.zeros(num_frames, np.int32)
    sign = np.zeros(num_frames, np.int32)
    seen = np.zeros(num_frames, bool)
    for root in range(num_frames):
        if seen[root]:
            continue
        seen[root] = True
        dq = deque([root])
        while dq:
            u = dq.popleft()
            for v, e in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    parent[v] = u
                    eidx[v] = e
                    sign[v] = 1 if ei[e] == u else -1
                    dq.append(v)
    return parent, eidx, sign


def initialize_rotations_tree(num_frames: int, g: RotationGraph, parent, edge_idx,
                              sign) -> torch.Tensor:
    """Compose global rotations along a spanning tree by pointer doubling:
    R[v] = A[v]·A[parent]·…·I with A[v] the parent→v relative rotation.
    g.r_meas may carry leading batch axes (one tree, many measurement sets)."""
    dtype, dev = g.r_meas.dtype, g.r_meas.device
    parent = torch.as_tensor(np.asarray(parent), dtype=torch.int64, device=dev)
    s = torch.as_tensor(np.asarray(sign), device=dev)[:, None, None]
    eidx = torch.as_tensor(np.asarray(edge_idx), dtype=torch.int64, device=dev)
    Re = so3_exp(g.r_meas)[..., eidx, :, :]
    A = torch.where(s > 0, Re, Re.transpose(-1, -2))
    M = torch.where(s == 0, torch.eye(3, dtype=dtype, device=dev), A)
    for _ in range(max(1, math.ceil(math.log2(max(num_frames, 2))) + 1)):
        M = M @ M[..., parent, :, :]
        parent = parent[parent]
    return so3_log(M)


def initialize_rotations_global(num_frames: int, g: RotationGraph, weights=None):
    """Heaviest spanning tree + pointer-doubling composition."""
    w = g.edge_w.cpu().numpy() if weights is None else np.asarray(weights)
    parent, eidx, sign = build_spanning_tree(
        num_frames, g.edge_i.cpu().numpy(), g.edge_j.cpu().numpy(), w)
    return initialize_rotations_tree(num_frames, g, parent, eidx, sign)


def rotations_at_focal(E_mats: torch.Tensor, focal_ratio, inward: bool = False) -> torch.Tensor:
    """Re-decompose each pairwise essential matrix under a focal rescale
    s = f/f₀: E' = diag(s,s,1)·E·diag(s,s,1), then the closed-form spherical
    decomposition. E_mats (E, 3, 3); a (T, 1) `focal_ratio` gives (T, E, 3)."""
    r, _ = decompose_spherical_essential(conjugate_essential_by_focal(E_mats, focal_ratio),
                                         inward=inward)
    return r


def _sweep(focals, focal_guess, E_mats, edge_i, edge_j, edge_w, num_frames, inward, tree,
           cost_of):
    """`cost_of(rotations (T, N, 3), graph)` for every focal hypothesis, in
    chunks of at most SWEEP_BATCH hypothesis-edges."""
    edge_i, edge_j = torch.as_tensor(edge_i).long(), torch.as_tensor(edge_j).long()
    edge_w = torch.as_tensor(edge_w, dtype=E_mats.dtype, device=E_mats.device)
    if tree is None:
        tree = _sequential_tree(num_frames, edge_i.cpu().numpy(), edge_j.cpu().numpy(),
                               edge_w.cpu().numpy())
    edge_i, edge_j = edge_i.to(E_mats.device), edge_j.to(E_mats.device)
    focals = torch.as_tensor(focals, dtype=E_mats.dtype, device=E_mats.device)
    step = max(1, SWEEP_BATCH // max(E_mats.shape[0], 1))
    out = []
    for s in range(0, focals.shape[0], step):
        r_f = rotations_at_focal(E_mats, (focals[s:s + step] / focal_guess)[:, None], inward)
        g = RotationGraph(edge_i, edge_j, r_f, edge_w)
        out.append(cost_of(initialize_rotations_tree(num_frames, g, *tree), g))
    return torch.cat(out)


def loop_constraint_costs(focals, focal_guess, E_mats, edge_i, edge_j, edge_w,
                          num_frames: int, inward: bool = False, tree=None) -> torch.Tensor:
    """Pose-graph cost of each focal hypothesis: conjugate E by f/f₀,
    re-decompose, chain a rotation init (sequential, or along the spanning
    `tree` (parent, edge_idx, sign)), evaluate the robust loop cost."""
    return _sweep(focals, focal_guess, E_mats, edge_i, edge_j, edge_w, num_frames, inward,
                  tree, pose_graph_cost)


def _total_rotation(rots, _g):
    R = so3_exp(rots)
    rel = torch.einsum("...nji,...njk->...nik", R[..., 1:, :, :], R[..., :-1, :, :])
    total = torch.sum(torch.linalg.norm(so3_log(rel), dim=-1), dim=-1)
    return torch.abs(2.0 * math.pi - total)


def total_rotation_costs(focals, focal_guess, E_mats, edge_i, edge_j, edge_w,
                         num_frames: int, inward: bool = False, tree=None) -> torch.Tensor:
    """|2π − Σ‖log(R_iᵀR_{i−1})‖| of each focal hypothesis: a closed
    circular capture turns exactly once over consecutive frames."""
    return _sweep(focals, focal_guess, E_mats, edge_i, edge_j, edge_w, num_frames, inward,
                  tree, _total_rotation)


def _focal_costs(cost: str):
    return total_rotation_costs if cost == "total_rotation" else loop_constraint_costs


def _make_tree(sequential, num_frames, edge_i, edge_j, edge_w):
    if sequential:
        return None
    return build_spanning_tree(num_frames, torch.as_tensor(edge_i).cpu().numpy(),
                               torch.as_tensor(edge_j).cpu().numpy(),
                               torch.as_tensor(edge_w).cpu().numpy())


def _argmin_finite(costs):
    return torch.argmin(torch.where(torch.isfinite(costs), costs,
                                    torch.full_like(costs, float("inf"))))


def find_best_focal_grid(focal_guess, E_mats, edge_i, edge_j, edge_w, num_frames: int,
                         min_focal, max_focal, num_steps: int = 64, inward: bool = False,
                         sequential: bool = True, cost: str = "loop"):
    """Uniform-grid focal search over `num_steps` hypotheses in one sweep.
    Returns (best_focal, costs, focals)."""
    focals = torch.linspace(float(min_focal), float(max_focal), num_steps,
                            dtype=E_mats.dtype, device=E_mats.device)
    costs = _focal_costs(cost)(focals, focal_guess, E_mats, edge_i, edge_j, edge_w,
                               num_frames, inward,
                               _make_tree(sequential, num_frames, edge_i, edge_j, edge_w))
    return focals[_argmin_finite(costs)], costs, focals


def find_best_focal_bracketed(gen: torch.Generator, focal_guess, E_mats, edge_i, edge_j,
                              edge_w, num_frames: int, min_focal, max_focal,
                              rounds: int = 6, points_per_round: int = 16,
                              inward: bool = False, sequential: bool = True,
                              cost: str = "loop", max_restarts: int = 100):
    """Bracketed 1-D focal minimization: find an interior point that beats
    both ends (random restarts from `gen`), then `rounds` sub-grid sweeps
    shrinking around the argmin. Returns (best_focal, ok); ok is False when
    no bracket was found."""
    tree = _make_tree(sequential, num_frames, edge_i, edge_j, edge_w)
    costs_fn = _focal_costs(cost)

    def eval_costs(fs):
        return costs_fn(np.asarray(fs, np.float64), focal_guess, E_mats, edge_i, edge_j,
                        edge_w, num_frames, inward, tree).cpu().numpy()

    lo, hi = float(min_focal), float(max_focal)
    mid = float(focal_guess)
    end_costs = eval_costs([lo, hi])
    mid_cost = eval_costs([mid])[0]
    tries = 0
    while mid_cost >= min(end_costs):
        if tries >= max_restarts:
            return mid, False
        mid = lo + (hi - lo) * float(torch.rand((), generator=gen, device=gen.device))
        mid_cost = eval_costs([mid])[0]
        tries += 1

    a, b = lo, hi
    for _ in range(rounds):
        fs = np.sort(np.append(np.linspace(a, b, points_per_round), mid))
        i = int(np.nanargmin(eval_costs(fs)))
        a = fs[max(i - 1, 0)]
        b = fs[min(i + 1, len(fs) - 1)]
        mid = float(fs[i])
    return mid, True


def find_best_focal_random(gen: torch.Generator, focal_guess, E_mats, edge_i, edge_j,
                           edge_w, num_frames: int, min_focal, max_focal,
                           num_trials: int = 1024, inward: bool = False,
                           sequential: bool = True):
    """Random focal search: `num_trials` uniform draws from `gen` plus the
    guess itself, one batched loop-cost sweep. Returns (best_focal, costs,
    focals)."""
    dtype, dev = E_mats.dtype, E_mats.device
    draws = torch.rand(num_trials, generator=gen, device=gen.device, dtype=dtype).to(dev)
    focals = torch.cat([float(min_focal) + (float(max_focal) - float(min_focal)) * draws,
                        torch.tensor([float(focal_guess)], dtype=dtype, device=dev)])
    costs = loop_constraint_costs(focals, focal_guess, E_mats, edge_i, edge_j, edge_w,
                                  num_frames, inward,
                                  _make_tree(sequential, num_frames, edge_i, edge_j, edge_w))
    return focals[_argmin_finite(costs)], costs, focals
