"""Robust rotation averaging for the calibrated driver — port of the
calibrated part of `sphericalsfm_tpu/optim/pose_graph.py`.

Per-camera axis-angle rotations, cycle residual scale·log(R₁R₀ᵀR_measᵀ)
with scale = 1/max‖log R_meas‖, SoftL1(0.03) loss, first camera fixed.
Each LM iteration takes per-edge Jacobian blocks from `torch.func.jacfwd`,
assembles the dense (3N)² normal equations with `index_add_`, and solves by
an equilibrated Cholesky. The focal machinery of the uncalibrated driver
is not ported yet.
"""

from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.so3 import so3_exp, so3_log
from .lm import soft_l1_rho, soft_l1_weight

SOFT_L1_SCALE = 0.03


class RotationGraph(NamedTuple):
    """Edge list of relative-rotation measurements i -> j (i < j)."""

    edge_i: torch.Tensor   # (E,) int64
    edge_j: torch.Tensor   # (E,)
    r_meas: torch.Tensor   # (E, 3) axis-angle of R_ij (x_j = R_ij x_i)
    edge_w: torch.Tensor   # (E,) weight (0 = unused)


def _edge_scale(g: RotationGraph) -> torch.Tensor:
    norms = torch.where(g.edge_w > 0, torch.linalg.norm(g.r_meas, dim=-1),
                        torch.zeros_like(g.edge_w))
    return 1.0 / torch.clamp(norms.max(), min=1e-12)


def _cycle_residual(r0, r1, r_meas, scale):
    """scale · log(R₁ R₀ᵀ R_measᵀ), batched over leading axes."""
    R0, R1, Rm = so3_exp(r0), so3_exp(r1), so3_exp(r_meas)
    return scale * so3_log((R1 @ R0.transpose(-1, -2)) @ Rm.transpose(-1, -2))


def pose_graph_cost(rotations_r: torch.Tensor, g: RotationGraph) -> torch.Tensor:
    """0.5·Σ ρ_softL1(‖res‖²) at fixed rotations."""
    res = _cycle_residual(rotations_r[g.edge_i], rotations_r[g.edge_j], g.r_meas,
                          _edge_scale(g))
    s = torch.sum(res * res, dim=-1)
    rho = soft_l1_rho(s, SOFT_L1_SCALE)
    return 0.5 * torch.sum(torch.where(g.edge_w > 0, rho, torch.zeros_like(rho)))


def optimize_rotations(rotations_r: torch.Tensor, g: RotationGraph, max_iters: int = 64,
                       solver: str = "auto", ftol: float = 1e-12):
    """Robust rotation averaging; camera 0 is the gauge anchor.

    Returns (rotations (N, 3), final cost). Only the dense solve is ported;
    `solver="pcg"` raises NotImplementedError."""
    if solver == "pcg":
        raise NotImplementedError("the PCG pose-graph solver is not ported yet")
    N = rotations_r.shape[0]
    dtype, dev = rotations_r.dtype, rotations_r.device
    D = 3 * N
    ei, ej = g.edge_i.long(), g.edge_j.long()
    live = g.edge_w > 0
    scale = _edge_scale(g)
    free = torch.ones(N, dtype=dtype, device=dev)
    free[0] = 0.0

    def edge_res(packed, r_meas):
        return _cycle_residual(packed[:3], packed[3:], r_meas, scale)

    jac = torch.func.vmap(torch.func.jacfwd(edge_res))

    def total_cost(rots):
        res = _cycle_residual(rots[ei], rots[ej], g.r_meas, scale)
        rho = soft_l1_rho(torch.sum(res * res, dim=-1), SOFT_L1_SCALE)
        return 0.5 * torch.sum(torch.where(live, rho, torch.zeros_like(rho)))

    def build_system(rots):
        packed = torch.cat([rots[ei], rots[ej]], dim=-1)         # (E, 6)
        res = _cycle_residual(rots[ei], rots[ej], g.r_meas, scale)
        J = jac(packed, g.r_meas)                                 # (E, 3, 6)
        w = soft_l1_weight(torch.sum(res * res, dim=-1), SOFT_L1_SCALE) * live
        J0 = J[:, :, :3] * free[ei][:, None, None]
        J1 = J[:, :, 3:] * free[ej][:, None, None]
        wj = w[:, None, None]
        A0 = torch.einsum("edi,edj->eij", J0 * wj, J0)
        A1 = torch.einsum("edi,edj->eij", J1 * wj, J1)
        C01 = torch.einsum("edi,edj->eij", J0 * wj, J1)
        g0 = torch.einsum("edi,ed->ei", J0 * wj, res)
        g1 = torch.einsum("edi,ed->ei", J1 * wj, res)
        H = torch.zeros((N * N, 3, 3), dtype=dtype, device=dev)
        H.index_add_(0, ei * N + ej, C01)
        H = H.reshape(N, N, 3, 3)
        H = H + H.permute(1, 0, 3, 2)
        diag = torch.zeros((N, 3, 3), dtype=dtype, device=dev)
        diag.index_add_(0, ei, A0)
        diag.index_add_(0, ej, A1)
        ar = torch.arange(N, device=dev)
        H[ar, ar] += diag
        gvec = torch.zeros((N, 3), dtype=dtype, device=dev)
        gvec.index_add_(0, ei, g0)
        gvec.index_add_(0, ej, g1)
        return H.permute(0, 2, 1, 3).reshape(D, D), gvec.reshape(D)

    eye = torch.eye(D, dtype=dtype, device=dev)
    rots = rotations_r
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    cost = total_cost(rots)
    for _ in range(max_iters):
        H, gvec = build_system(rots)
        diag = torch.clamp(torch.diagonal(H), min=1e-12)
        A = H + torch.diag(lam * diag)
        dscale = torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-15))
        A_eq = A / dscale[:, None] / dscale[None, :]
        L, _ = torch.linalg.cholesky_ex(A_eq + 1e-12 * eye)
        dx = torch.cholesky_solve((-(gvec / dscale))[:, None], L)[:, 0] / dscale
        rots_n = rots + dx.reshape(N, 3) * free[:, None]
        cost_n = total_cost(rots_n)
        ok = bool(torch.isfinite(cost_n) & (cost_n < cost))
        rel = float((cost - cost_n) / torch.clamp(cost, min=1e-30))
        if ok:
            lam = torch.clamp(lam * 0.33, min=1e-12)
            rots, cost = rots_n, cost_n
        else:
            lam = lam * 4.0
        if (ok and rel < ftol) or float(lam) > 1e10:
            break
    return rots, cost


def initialize_rotations_sequential(num_frames: int, g: RotationGraph) -> torch.Tensor:
    """Chain adjacent relative rotations (missing links are identity)."""
    dtype, dev = g.r_meas.dtype, g.r_meas.device
    adj = ((g.edge_j == g.edge_i + 1) & (g.edge_w > 0)).cpu().numpy()
    Rm = so3_exp(g.r_meas)
    links = torch.eye(3, dtype=dtype, device=dev).repeat(num_frames, 1, 1)
    for e in np.nonzero(adj)[0]:
        links[int(g.edge_j[e])] = Rm[e]
    Rg = [links[0]]
    for j in range(1, num_frames):
        Rg.append(links[j] @ Rg[-1])
    return so3_log(torch.stack(Rg))


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
    R[v] = A[v]·A[parent]·…·I with A[v] the parent→v relative rotation."""
    dtype, dev = g.r_meas.dtype, g.r_meas.device
    parent = torch.as_tensor(parent, dtype=torch.int64, device=dev)
    sign = torch.as_tensor(sign, device=dev)
    Re = so3_exp(g.r_meas)[torch.as_tensor(edge_idx, dtype=torch.int64, device=dev)]
    eye = torch.eye(3, dtype=dtype, device=dev).expand_as(Re)
    A = torch.where((sign > 0)[:, None, None], Re, Re.transpose(-1, -2))
    M = torch.where((sign == 0)[:, None, None], eye, A)
    for _ in range(max(1, math.ceil(math.log2(max(num_frames, 2))) + 1)):
        M = M @ M[parent]
        parent = parent[parent]
    return so3_log(M)


def initialize_rotations_global(num_frames: int, g: RotationGraph, weights=None):
    """Heaviest spanning tree + pointer-doubling composition."""
    w = g.edge_w.cpu().numpy() if weights is None else np.asarray(weights)
    parent, eidx, sign = build_spanning_tree(
        num_frames, g.edge_i.cpu().numpy(), g.edge_j.cpu().numpy(), w)
    return initialize_rotations_tree(num_frames, g, parent, eidx, sign)
