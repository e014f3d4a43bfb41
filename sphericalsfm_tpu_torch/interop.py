"""Carry the JAX package's state across to the port.

The system has no weights: its "parameters" are the config, the solver
constants and the driver's intermediate state. These helpers take that
state as numpy arrays (for example `np.asarray` of a JAX array, or any
object whose fields convert with `np.asarray`) and build the port's
counterparts, so tests can hand both packages the same inputs. Nothing here
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import PipelineConfig
from .device import GEOM_DTYPE
from .io.colmap import ColmapDatabase
from .optim.ba import BAProblem
from .optim.pose_graph import RotationGraph
from .pipeline.driver import FrontendResult
from .pipeline.frontend import FrameFeatures


def config_from_json(s: str) -> PipelineConfig:
    """A JAX `PipelineConfig.to_json()` string → the port's PipelineConfig."""
    return PipelineConfig.from_json(s)


def frontend_from_numpy(feats, pair_i, pair_j, idx0, idx1, mmask) -> FrontendResult:
    """FrontendResult fields (a JAX FrameFeatures-like object plus the match
    tables) → the port's FrontendResult with host numpy tables."""
    ff = FrameFeatures(
        xy=np.asarray(feats.xy), descriptor=np.asarray(feats.descriptor, np.float32),
        valid=np.asarray(feats.valid), color=np.asarray(feats.color),
        counts=np.asarray(feats.counts), width=int(feats.width), height=int(feats.height))
    return FrontendResult(ff, np.asarray(pair_i), np.asarray(pair_j), np.asarray(idx0),
                          np.asarray(idx1), np.asarray(mmask))


def ba_problem_from_numpy(p, device="cpu") -> BAProblem:
    """A JAX BAProblem (or any object with its field names) → the port's."""
    dev = torch.device(device)

    def f64(x):
        return torch.as_tensor(np.array(x, np.float64), dtype=GEOM_DTYPE, device=dev)

    def idx(x):
        return torch.as_tensor(np.array(x, np.int64), device=dev)

    def flag(x):
        return torch.as_tensor(np.array(x, bool), device=dev)

    return BAProblem(
        focal=f64(p.focal), cam_t=f64(p.cam_t), cam_r=f64(p.cam_r), points=f64(p.points),
        obs_cam=idx(p.obs_cam), obs_pt=idx(p.obs_pt), obs_uv=f64(p.obs_uv),
        obs_w=f64(p.obs_w), focal_fixed=flag(p.focal_fixed), rot_fixed=flag(p.rot_fixed),
        trans_fixed=flag(p.trans_fixed), point_fixed=flag(p.point_fixed))


def rotation_graph_from_numpy(edge_i, edge_j, r_meas, edge_w, device="cpu") -> RotationGraph:
    """Edge-list arrays of a JAX RotationGraph → the port's RotationGraph."""
    dev = torch.device(device)
    return RotationGraph(
        edge_i=torch.as_tensor(np.array(edge_i, np.int64), device=dev),
        edge_j=torch.as_tensor(np.array(edge_j, np.int64), device=dev),
        r_meas=torch.as_tensor(np.array(r_meas, np.float64), device=dev),
        edge_w=torch.as_tensor(np.array(edge_w, np.float64), device=dev))


def focal_search_inputs_from_numpy(E_mats, edge_i, edge_j, edge_w, focals, device="cpu"):
    """The focal sweep's inputs (pairwise essential matrices, edge list,
    edge weights, focal hypotheses) → float64 / int64 tensors, in the
    argument order of `loop_constraint_costs` less `focal_guess`."""
    dev = torch.device(device)
    return (torch.as_tensor(np.array(focals, np.float64), device=dev),
            torch.as_tensor(np.array(E_mats, np.float64), device=dev),
            torch.as_tensor(np.array(edge_i, np.int64), device=dev),
            torch.as_tensor(np.array(edge_j, np.int64), device=dev),
            torch.as_tensor(np.array(edge_w, np.float64), device=dev))


def colmap_database_from_numpy(db) -> ColmapDatabase:
    """A JAX ColmapDatabase (or any object with its fields) → the port's."""
    return ColmapDatabase(
        intrinsics=tuple(float(x) for x in db.intrinsics), width=int(db.width),
        height=int(db.height), names=list(db.names),
        keypoints=[np.asarray(k, np.float32) for k in db.keypoints],
        descriptors=[np.asarray(d, np.float32) for d in db.descriptors],
        matches={(int(i), int(j)): np.asarray(m, np.int32) for (i, j), m in db.matches.items()})
