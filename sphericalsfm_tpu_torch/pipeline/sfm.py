"""The SfM map: host-side reconstruction state plus device compute — port of
`sphericalsfm_tpu/pipeline/sfm.py::SfMMap`.

Cameras, points and observations live in numpy tables on the host; the
compute stages (RANSAC retriangulation of every track, robust BA) upload
them to the map's device as float64 tensors. Writers produce the same
bytes as the JAX package's. BA picks its camera solver as the JAX map
does, on the camera count rounded up its 1.25× ladder (the JAX map pads
its tensors to that count; the port does not pad). Under a profiler
(`tracing`), retriangulation is the span `stage:sfm.retriangulate`, BA's
problem building `stage:ba.prepare`, and each writer `stage:write.poses`,
`.obj` or `.colmap`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import GEOM_DTYPE, resolve_device
from ..geometry.pose import Intrinsics
from ..geometry.so3 import np_so3_exp, np_so3_log
from ..optim.ba import (
    MAX_DENSE_CAMERAS, BAProblem, build_tracks, bundle_adjust, prepare_problem,
    resolve_camera_solver, sort_obs_by_camera,
)
from ..ransac.triangulation import triangulation_ransac
from ..tracing import span
from .tracks import Tracks


def camera_bucket(C: int) -> int:
    """The JAX map's padded camera count: 8-aligned 1.25× steps (408 stays
    408, 409–504 → 504, 505–624 → 624)."""
    Cp = 8
    while Cp < C:
        Cp = max(Cp + 8, int(Cp * 1.25) // 8 * 8)
    return Cp


@dataclass
class SfMMap:
    intrinsics: Intrinsics
    inward: bool = False
    device: torch.device = torch.device("cpu")

    cam_t: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    cam_r: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    paths: list = field(default_factory=list)
    rotation_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    translation_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    focal_fixed: bool = True

    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    point_fixed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))

    obs_cam: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obs_pt: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    obs_uv: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    obs_valid: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))

    @classmethod
    def build(cls, intrinsics: Intrinsics, rotations_r: np.ndarray, tracks: Tracks,
              keypoints: np.ndarray, colors: np.ndarray | None = None,
              spherical: bool = True, inward: bool = False, fix_camera: int = 0,
              paths: list | None = None, device=None) -> "SfMMap":
        """Cameras at t = (0,0,∓1) with the given rotations (translations
        frozen in spherical mode, one rotation frozen), observations centred
        at the principal point. The map computes on `device` (None: CUDA)."""
        C = rotations_r.shape[0]
        tz = 1.0 if inward else -1.0
        m = cls(intrinsics=intrinsics, inward=inward, device=resolve_device(device))
        m.cam_r = np.asarray(rotations_r, float).copy()
        m.cam_t = np.tile(np.array([0.0, 0.0, tz]), (C, 1))
        m.paths = list(paths) if paths is not None else [f"{i:06d}.png" for i in range(C)]
        m.rotation_fixed = np.zeros(C, bool)
        m.rotation_fixed[fix_camera] = True
        m.translation_fixed = np.full(C, bool(spherical))
        P = tracks.num_points
        m.points = np.zeros((P, 3))
        m.point_fixed = np.zeros(P, bool)
        cx, cy = float(intrinsics.cx), float(intrinsics.cy)
        uv = np.asarray(keypoints)[tracks.obs_cam, tracks.obs_feat] - np.array([cx, cy])
        m.obs_cam = tracks.obs_cam.copy()
        m.obs_pt = tracks.obs_pt.copy()
        m.obs_uv = uv
        m.obs_valid = np.ones(len(uv), bool)
        m.colors = np.zeros((P, 3), np.uint8)
        if colors is not None:
            m.colors[tracks.obs_pt] = np.asarray(colors)[tracks.obs_cam, tracks.obs_feat]
        return m

    @property
    def num_cameras(self) -> int:
        return self.cam_r.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    def point_valid(self) -> np.ndarray:
        return np.linalg.norm(self.points, axis=-1) > 0

    def centers(self) -> np.ndarray:
        return -np.einsum("cji,cj->ci", np_so3_exp(self.cam_r), self.cam_t)

    def _tensor(self, x, dtype=GEOM_DTYPE):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def retriangulate(self, gen: torch.Generator, sq_thresh: float = 4.0,
                      num_hypotheses: int = 32, chunk: int = 16384, mesh=None):
        """RANSAC-retriangulate every track: tracks with <3 valid
        observations zero out; successes need ≥3 inliers at 2 px. With
        `mesh`, each chunk's tracks split over its shards after the chunk's
        draws (`parallel.sharded_retriangulate`)."""
        if self.num_points == 0:
            return
        with span("stage:sfm.retriangulate"):
            nmax = int(np.bincount(self.obs_pt, minlength=1).max())
            T = 4
            while T < nmax:
                T *= 2
            track_obs, track_mask = build_tracks(self.obs_pt, self.num_points, max_track=T)
            track_mask = track_mask & self.obs_valid[track_obs]
            cam = self.obs_cam[track_obs]
            rs, ts = self.cam_r[cam], self.cam_t[cam]
            uv = self.obs_uv[track_obs]
            focal = float(self.intrinsics.focal)
            X, ok = [], []
            for s in range(0, self.num_points, chunk):
                e = s + chunk
                res = triangulation_ransac(
                    gen, self._tensor(rs[s:e]), self._tensor(ts[s:e]), self._tensor(uv[s:e]),
                    self._tensor(track_mask[s:e], torch.bool), focal,
                    sq_thresh=sq_thresh, num_hypotheses=num_hypotheses,
                    devices=None if mesh is None else mesh.devices)
                X.append(res.X)
                ok.append(res.ok)
            X = torch.cat(X).cpu().numpy()
            ok = torch.cat(ok).cpu().numpy()
            self.points = np.where(ok[:, None], X, 0.0)

    def optimize(self, max_iters: int = 100, solve_dtype: str = "float64",
                 loss_scale: float = 1.0, ftol: float = 1e-6, pcg_rtol: float = 1e-4,
                 pcg_iters: int = 100, init_lambda: float = 1e-4,
                 init_dec: float = 2.0, mesh=None) -> dict:
        """Robust BA: points with <3 observations or at the origin are
        excluded; Cauchy loss; Ceres' default function tolerance 1e-6. The
        PCG camera solve (above 512 bucketed cameras or the pair cap) runs
        at `pcg_rtol` / `pcg_iters`. With `mesh`, the problem's points and
        observations shard over it (`parallel.shard_ba_problem`), the
        solver chosen on the whole problem."""
        if self.num_cameras == 0 or self.num_points == 0:
            return {}
        t0 = time.perf_counter()
        with span("stage:ba.prepare"):
            nobs = np.bincount(self.obs_pt, weights=self.obs_valid.astype(float),
                               minlength=self.num_points)
            usable_pt = self.point_valid() & (nobs >= 3)
            w = (self.obs_valid & usable_pt[self.obs_pt]).astype(float)
            if w.sum() == 0:
                return {}
            b = torch.bool
            prob = BAProblem(
                focal=self._tensor(float(self.intrinsics.focal)),
                cam_t=self._tensor(self.cam_t), cam_r=self._tensor(self.cam_r),
                points=self._tensor(self.points),
                obs_cam=self._tensor(self.obs_cam, torch.int64),
                obs_pt=self._tensor(self.obs_pt, torch.int64),
                obs_uv=self._tensor(self.obs_uv), obs_w=self._tensor(w),
                focal_fixed=self._tensor(self.focal_fixed, b),
                rot_fixed=self._tensor(self.rotation_fixed, b),
                trans_fixed=self._tensor(self.translation_fixed, b),
                point_fixed=self._tensor(self.point_fixed | ~usable_pt, b))
            choice = "pcg" if camera_bucket(self.num_cameras) > MAX_DENSE_CAMERAS else "auto"
            if mesh is None:
                prob, solver = prepare_problem(prob, choice)
            else:
                from ..parallel.sharded import shard_ba_problem

                prob = sort_obs_by_camera(prob)
                solver = resolve_camera_solver(prob, choice)
                prob = shard_ba_problem(mesh, prob)
        t1 = time.perf_counter()
        res = bundle_adjust(prob, max_iters=max_iters, loss_scale=loss_scale, ftol=ftol,
                            solve_dtype_name=solve_dtype, camera_solver=solver,
                            pcg_rtol=pcg_rtol, pcg_iters=pcg_iters, init_lambda=init_lambda,
                            init_dec=init_dec)
        self.cam_t = res.cam_t.cpu().numpy()
        self.cam_r = res.cam_r.cpu().numpy()
        self.points = np.where(usable_pt[:, None], res.points.cpu().numpy(), self.points)
        focal = float(res.focal)
        t2 = time.perf_counter()
        self.intrinsics = Intrinsics(focal, self.intrinsics.cx, self.intrinsics.cy)
        return {
            "initial_cost": float(res.initial_cost),
            "final_cost": float(res.cost),
            "iterations": int(res.iterations),
            "focal": focal,
            "prep_s": round(t1 - t0, 2),
            "solve_s": round(t2 - t1, 2),
            "lam": float(res.lam),
            "solver": solver,
            "pcg_iterations": res.pcg_iterations,
        }

    def reprojection_errors(self) -> np.ndarray:
        """Per-observation reprojection error in pixels."""
        R = np_so3_exp(self.cam_r)
        PX = (np.einsum("kij,kj->ki", R[self.obs_cam], self.points[self.obs_pt])
              + self.cam_t[self.obs_cam])
        z = np.where(np.abs(PX[:, 2]) > 1e-12, PX[:, 2], 1e-12)
        proj = float(self.intrinsics.focal) * PX[:, :2] / z[:, None]
        return np.linalg.norm(proj - self.obs_uv, axis=-1)

    def filter_observations(self, thresh_px: float) -> int:
        """Invalidate observations above the reprojection threshold; points
        left with no valid observation zero out."""
        nobs = np.bincount(self.obs_pt, weights=self.obs_valid.astype(float),
                           minlength=self.num_points)
        eligible = self.point_valid() & (nobs >= 3)
        bad = self.obs_valid & eligible[self.obs_pt] & (
            self.reprojection_errors() > thresh_px)
        self.obs_valid &= ~bad
        left = np.bincount(self.obs_pt, weights=self.obs_valid.astype(float),
                           minlength=self.num_points)
        self.points[left == 0] = 0.0
        return int(bad.sum())

    def apply_pose(self, R: np.ndarray, t: np.ndarray):
        """World map X → R X + t; cameras post-multiply by the inverse."""
        Rn = np_so3_exp(self.cam_r) @ R.T
        self.cam_t = self.cam_t - np.einsum("cij,j->ci", Rn, t)
        self.cam_r = np_so3_log(Rn)
        valid = self.point_valid()
        self.points = np.where(valid[:, None], self.points @ R.T + t, self.points)

    def apply_scale(self, s: float):
        self.cam_t = self.cam_t * s
        valid = self.point_valid()
        self.points = np.where(valid[:, None], self.points * s, self.points)

    def normalize(self):
        """Centre the camera centroid, unit mean radius, flip if inverted."""
        self.apply_pose(np.eye(3), -self.centers().mean(axis=0))
        self.apply_scale(1.0 / max(np.linalg.norm(self.centers(), axis=-1).mean(), 1e-12))
        tz = self.cam_t[0, 2]
        if (self.inward and tz < 0) or ((not self.inward) and tz > 0):
            self.apply_scale(-1.0)

    def write_poses(self, path: str, indices=None):
        """poses.txt: index + t then r, 15 decimals."""
        idx = indices if indices is not None else list(range(self.num_cameras))
        with span("stage:write.poses"), open(path, "w") as f:
            for i in range(self.num_cameras):
                vals = list(self.cam_t[i]) + list(self.cam_r[i])
                f.write(f"{idx[i]} " + " ".join(f"{v:.15f}" for v in vals) + " \n")

    def write_points_obj(self, path: str, max_distance: float = 2000.0):
        """OBJ point cloud, dropping points farther than `max_distance` from
        the camera of their last valid observation."""
        with span("stage:write.obj"):
            c = self.centers()
            valid = self.point_valid()
            last = np.full(self.num_points, -1, np.int64)
            live = np.nonzero(self.obs_valid)[0]
            np.maximum.at(last, self.obs_pt[live], live)
            with open(path, "w") as f:
                for j in np.nonzero(valid)[0]:
                    if last[j] >= 0 and np.linalg.norm(
                            self.points[j] - c[self.obs_cam[last[j]]]) > max_distance:
                        continue
                    X = self.points[j]
                    f.write(f"v {X[0]:.15f} {X[1]:.15f} {X[2]:.15f}\n")

    def write_camera_centers_obj(self, path: str):
        with span("stage:write.obj"), open(path, "w") as f:
            for ctr in self.centers():
                f.write(f"v {ctr[0]:.15f} {ctr[1]:.15f} {ctr[2]:.15f}\n")

    def write_colmap(self, sparse_dir: str, width: int, height: int):
        from ..io.colmap import write_colmap_text

        with span("stage:write.colmap"):
            write_colmap_text(self, sparse_dir, width, height)
