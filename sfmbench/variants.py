"""Controls and faults: the program run with one thing changed, to show
that the comparison which decides `correct` fails them.

Controls (a path the program has, switched on):
* `float32`: the port's geometry dtype (`GEOM_DTYPE`, float64) replaced by
  float32 in every module that reads it: pairwise RANSAC, the focal
  search's sweep, retriangulation and bundle adjustment with its camera
  solve. One step below the float64 the configurations state. The port's
  rotation-averaging LM has no float32 path (its Jacobian comes out in
  float64 and the solve raises on the mix), so its two calls take float64
  inputs and hand float32 back;
* `ba_early`: every bundle adjustment stopped after 2 LM iterations, short
  of the stopping rule the configurations state (a relative decrease
  under 1e-9).

Faults (the timed path broken underneath):
* `state_unchanged`: bundle adjustment returns its state unchanged;
* `half_frames`: the second half of the capture's frames reach the
  detector blank, so half of the batch is left out;
* `answer_altered`: one camera's translation moved by 1e-3 where the
  poses are written.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

CONTROLS = ("float32", "ba_early")
# the modules that read the port's geometry dtype at call time
GEOM_MODULES = ("interop", "pipeline.driver", "pipeline.pairwise", "pipeline.sfm",
                "ransac.sixpoint")
FAULTS = ("state_unchanged", "half_frames", "answer_altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _in_float64(fn):
    """`fn` with its float32 tensors (and those of a RotationGraph) raised to
    float64, and its float64 tensor results lowered to float32."""
    def up(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.double()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(up(v) for v in x))
        return x

    def down(x):
        return x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.float64 else x

    def call(*args, **kwargs):
        out = fn(*(up(a) for a in args), **{k: up(v) for k, v in kwargs.items()})
        return tuple(down(v) for v in out)
    return call


@contextlib.contextmanager
def variant(name: str, cfg):
    """Install variant `name` ("sound" for none) on the program and on its
    PipelineConfig `cfg` for the duration of the block."""
    import importlib

    from sphericalsfm_tpu_torch.pipeline import driver, sfm

    with contextlib.ExitStack() as stack:
        if name == "sound":
            pass
        elif name == "float32":
            for mod in GEOM_MODULES:
                m = importlib.import_module(f"sphericalsfm_tpu_torch.{mod}")
                stack.enter_context(_patched(m, "GEOM_DTYPE", torch.float32))
            real = sfm.SfMMap._tensor            # its default was bound at definition

            def _tensor(self, x, dtype=torch.float32):
                return real(self, x, torch.float32 if dtype == torch.float64 else dtype)

            stack.enter_context(_patched(sfm.SfMMap, "_tensor", _tensor))
            stack.enter_context(_patched(cfg.ba, "solve_dtype", "float32"))
            for fn in ("optimize_rotations", "optimize_rotations_and_focal"):
                stack.enter_context(_patched(driver, fn, _in_float64(getattr(driver, fn))))
        elif name == "ba_early":
            stack.enter_context(_patched(cfg.ba, "max_iters", 2))
        elif name == "state_unchanged":
            stack.enter_context(_patched(sfm.SfMMap, "optimize", lambda self, *a, **kw: {}))
        elif name == "half_frames":
            real = driver.detect_features

            def detect_features(gray, *args, **kwargs):
                gray = np.array(gray)
                gray[len(gray) // 2:] = 0
                return real(gray, *args, **kwargs)

            stack.enter_context(_patched(driver, "detect_features", detect_features))
        elif name == "answer_altered":
            real = sfm.SfMMap.write_poses

            def write_poses(self, path, indices=None):
                kept = self.cam_t
                self.cam_t = kept.copy()
                self.cam_t[len(kept) // 2] += 1e-3
                try:
                    real(self, path, indices)
                finally:
                    self.cam_t = kept

            stack.enter_context(_patched(sfm.SfMMap, "write_poses", write_poses))
        else:
            raise ValueError(f"unknown variant {name!r}")
        yield
