"""Device and dtype policy of the port.

* Geometry, RANSAC, the pose graph and bundle adjustment run in float64 on
  both CPU and CUDA (the H100 has native FP64).
* The detector and the synthetic renderer run in float32.
* The matcher takes bfloat16 inputs and accumulates in float32.

The CUDA path never lets float32 matmuls or convolutions drop to TF32:
both flags are turned off when this module is imported and again whenever
a CUDA device is resolved. TF32 keeps ~3 decimal digits, enough to warp the
detector's DoG differences and the geometry contractions.

There is no silent fallback: `resolve_device(None)` means CUDA and raises
when no card is present. The CPU path runs only when a caller passes
`device="cpu"`.
"""

from __future__ import annotations

import torch

GEOM_DTYPE = torch.float64
DETECT_DTYPE = torch.float32
MATCH_DTYPE = torch.bfloat16


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


disable_tf32()


def resolve_device(device=None) -> torch.device:
    """The device a driver call runs on: None or "cuda" → CUDA (raises when
    `torch.cuda.is_available()` is False); "cpu" → the CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the CPU path")
        disable_tf32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on `device` (the port's stand-in for a JAX key)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
