"""The streaming two-nearest-neighbour matcher: CUDA kernel wrappers and
their plain PyTorch version — port of `sphericalsfm_tpu/ops/pallas_matching.py`.

`two_nearest_neighbors(desc, valid, pair_i, pair_j)` computes, for each pair
p and each query q of frame pair_j[p] against the train rows of frame
pair_i[p]: d = 2 − 2·⟨query, train⟩ over valid train rows, the smallest
(m1) and second-smallest (m2, = m1 on duplicates) d, and the argmin idx
(lowest index on ties, −1 when no train row is valid); invalid queries get
m1 = m2 = +inf. Inputs are cast to `compute_dtype` (bf16 by default) and
accumulate in float32.

On CUDA tensors the wrapper launches a hand-written kernel or raises:
bfloat16 goes to `csrc/two_nn_wgmma.cu` (tensor cores, TMA ring), float32
to `csrc/two_nn.cu`, the exact checker: 8 × 16 register micro-tiles of
FP32 FMAs fed by a TMA ring, each distance one fmaf chain over k in
ascending order, so its outputs are the first, simple float32 kernel's bit
for bit. Both take any pair count: the bf16 kernel's grid holds 65,535
pairs, so a larger call is split into launches of at most that many, each
writing its rows of the outputs. The sources are built with nvcc on first
use, with the port's other kernels, and bound with ctypes (`cuda_libs`).
On CPU tensors the wrapper runs `two_nn_reference`.
`two_nearest_neighbors.launches` counts kernel launches and
`two_nearest_neighbors.route_launches` splits them by kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_libs import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]
# route: (source under csrc/, C entry point, its argument types)
_KERNEL = Kernel("two_nn", {"wgmma_bf16": ("two_nn_wgmma.cu", "two_nn_wgmma_launch", _ARGS),
                            "fma_f32": ("two_nn.cu", "two_nn_f32_launch", _ARGS)})
_ROUTE = {torch.bfloat16: "wgmma_bf16", torch.float32: "fma_f32"}
_BF16_MAX_PAIRS = 65535        # the bf16 kernel's grid: pairs on gridDim.y
_F32_MAX_BLOCKS = 2 ** 31 - 1  # the f32 kernel's grid: pairs × query tiles on gridDim.x


def launch_slices(route: str, P: int, K: int) -> list:
    """[(start, stop), ...]: the pair ranges of the launches that cover P
    pairs of K keypoints on `route`, each within its kernel's grid."""
    if route == "wgmma_bf16":
        step = _BF16_MAX_PAIRS
    else:
        step = _F32_MAX_BLOCKS // -(-K // 128)
    return [(s, min(P, s + step)) for s in range(0, P, step)]


def two_nn_reference(desc, valid, pair_i, pair_j, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernels: cast to the compute dtype,
    inner products in float32, +inf bias on invalid train rows, top 2 with
    lowest-index ties. Same arguments and outputs as the wrapper."""
    pi = pair_i.long()
    pj = pair_j.long()
    d0 = desc[pi].to(compute_dtype).float()                  # (P, K, D) train
    d1 = desc[pj].to(compute_dtype).float()                  # (P, K, D) query
    ip = torch.einsum("pqd,ptd->pqt", d1, d0)
    inf = torch.full((), float("inf"), device=desc.device)
    bias0 = torch.where(valid[pi], torch.zeros((), device=desc.device), inf)
    d = 2.0 - 2.0 * ip + bias0[:, None, :]
    idx = torch.argmin(d, dim=-1)                            # first minimum
    m1 = torch.gather(d, -1, idx[..., None])[..., 0]
    m2 = torch.min(d.scatter(-1, idx[..., None], float("inf")), dim=-1).values
    idx = torch.where(m1 < inf, idx, torch.full_like(idx, -1)).to(torch.int32)
    qvalid = valid[pj]
    m1 = torch.where(qvalid, m1, inf)
    m2 = torch.where(qvalid, m2, inf)
    return m1, m2, idx


def two_nearest_neighbors(desc: torch.Tensor, valid: torch.Tensor,
                          pair_i: torch.Tensor, pair_j: torch.Tensor,
                          compute_dtype=torch.bfloat16, check_pairs: bool = True):
    """Two smallest d = 2 − 2⟨q, t⟩ and argmin per query of every pair.

    desc (F, K, 128) float, valid (F, K) bool, pair_i/pair_j (P,) frame
    indices (train, query). Returns m1, m2 (P, K) float32, idx (P, K) int32.
    A table already in `compute_dtype` is not copied. `check_pairs` checks
    that every pair index lies in [0, F) at the cost of one host sync; a
    caller that checked its pair list once passes False.
    """
    if desc.device.type == "cpu":
        return two_nn_reference(desc, valid, pair_i, pair_j, compute_dtype)
    if desc.device.type != "cuda":
        raise ValueError(f"unsupported device {desc.device}")
    if compute_dtype not in _ROUTE:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if desc.ndim != 3 or desc.shape[2] != 128:
        raise ValueError(f"desc must be (F, K, 128), got {tuple(desc.shape)}")
    F, K, D = desc.shape
    if valid.shape != (F, K) or valid.dtype != torch.bool:
        raise ValueError("valid must be a (F, K) bool tensor")
    if pair_i.shape != pair_j.shape or pair_i.ndim != 1:
        raise ValueError("pair_i and pair_j must be matching (P,) tensors")
    for name, t in (("valid", valid), ("pair_i", pair_i), ("pair_j", pair_j)):
        if t.device != desc.device:
            raise ValueError(f"{name} is on {t.device}, desc on {desc.device}")
    P = pair_i.shape[0]
    if check_pairs and P:
        lo, hi = torch.stack(torch.aminmax(torch.cat([pair_i, pair_j]))).tolist()
        if lo < 0 or hi >= F:
            raise ValueError(f"pair indices must lie in [0, {F})")
    d = (desc if desc.dtype == compute_dtype else desc.to(compute_dtype)).contiguous()
    v = valid.contiguous().view(torch.uint8)
    pi = pair_i.to(torch.int32).contiguous()
    pj = pair_j.to(torch.int32).contiguous()
    m1 = torch.empty((P, K), dtype=torch.float32, device=desc.device)
    m2 = torch.empty((P, K), dtype=torch.float32, device=desc.device)
    idx = torch.empty((P, K), dtype=torch.int32, device=desc.device)
    if P == 0:
        return m1, m2, idx
    route = _ROUTE[compute_dtype]
    if d.data_ptr() % 16:  # TMA reads the table from a 16-byte aligned address
        d = d.clone()
    for s, e in launch_slices(route, P, K):
        _KERNEL.launch(route, desc.device, d.data_ptr(), F, v.data_ptr(), pi[s:e].data_ptr(),
                       pj[s:e].data_ptr(), e - s, K, D, m1[s:e].data_ptr(), m2[s:e].data_ptr(),
                       idx[s:e].data_ptr())
        two_nearest_neighbors.launches += 1
        two_nearest_neighbors.route_launches[route] += 1
    return m1, m2, idx


two_nearest_neighbors.launches = 0
two_nearest_neighbors.route_launches = dict.fromkeys(_KERNEL.entries, 0)
