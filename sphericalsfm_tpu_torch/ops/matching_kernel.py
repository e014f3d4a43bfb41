"""The streaming two-nearest-neighbour matcher: CUDA kernel wrapper and its
plain PyTorch version — port of `sphericalsfm_tpu/ops/pallas_matching.py`.

`two_nearest_neighbors(desc, valid, pair_i, pair_j)` computes, for each pair
p and each query q of frame pair_j[p] against the train rows of frame
pair_i[p]: d = 2 − 2·⟨query, train⟩ over valid train rows, the smallest
(m1) and second-smallest (m2, = m1 on duplicates) d, and the argmin idx
(lowest index on ties, −1 when no train row is valid); invalid queries get
m1 = m2 = +inf. Inputs are cast to `compute_dtype` (bf16 by default) and
accumulate in float32.

On CUDA tensors the wrapper launches `csrc/two_nn.cu` (built with nvcc on
first use into `build/kernels/`, bound with ctypes) or raises; on CPU
tensors it runs `two_nn_reference`. `two_nearest_neighbors.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "two_nn.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the two-NN CUDA kernel cannot be built")
    return path


def build_library(verbose: bool = False) -> str:
    """Compile `csrc/two_nn.cu` for sm_90a into build/kernels/ (once per
    source content) and return the shared library's path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    lib_path = os.path.join(_BUILD_DIR, f"libtwo_nn_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, flush=True)
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        fn = lib.two_nn_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def two_nn_reference(desc, valid, pair_i, pair_j, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel: cast to the compute dtype,
    inner products in float32, +inf bias on invalid train rows, top 2 with
    lowest-index ties. Same arguments and outputs as the wrapper."""
    pi = pair_i.long()
    pj = pair_j.long()
    d0 = desc[pi].to(compute_dtype).float()                  # (P, K, D) train
    d1 = desc[pj].to(compute_dtype).float()                  # (P, K, D) query
    ip = torch.einsum("pqd,ptd->pqt", d1, d0)
    inf = torch.tensor(float("inf"), device=desc.device)
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
                          compute_dtype=torch.bfloat16):
    """Two smallest d = 2 − 2⟨q, t⟩ and argmin per query of every pair.

    desc (F, K, 128) float, valid (F, K) bool, pair_i/pair_j (P,) frame
    indices (train, query). Returns m1, m2 (P, K) float32, idx (P, K) int32.
    """
    if desc.device.type == "cpu":
        return two_nn_reference(desc, valid, pair_i, pair_j, compute_dtype)
    if desc.device.type != "cuda":
        raise ValueError(f"unsupported device {desc.device}")
    if compute_dtype not in _DTYPE_CODE:
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
    if P and not (0 <= int(torch.minimum(pair_i.min(), pair_j.min()))
                  and int(torch.maximum(pair_i.max(), pair_j.max())) < F):
        raise ValueError(f"pair indices must lie in [0, {F})")
    d = desc.to(compute_dtype).contiguous()
    v = valid.contiguous().view(torch.uint8)
    pi = pair_i.to(torch.int32).contiguous()
    pj = pair_j.to(torch.int32).contiguous()
    m1 = torch.empty((P, K), dtype=torch.float32, device=desc.device)
    m2 = torch.empty((P, K), dtype=torch.float32, device=desc.device)
    idx = torch.empty((P, K), dtype=torch.int32, device=desc.device)
    if P == 0:
        return m1, m2, idx
    err = _load().two_nn_launch(
        d.data_ptr(), _DTYPE_CODE[compute_dtype], v.data_ptr(), pi.data_ptr(),
        pj.data_ptr(), P, K, D, m1.data_ptr(), m2.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(desc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"two_nn kernel launch failed: cudaError {err}")
    two_nearest_neighbors.launches += 1
    return m1, m2, idx


two_nearest_neighbors.launches = 0
