"""Track building and view-graph hygiene on the host (numpy) — port of
`sphericalsfm_tpu/pipeline/tracks.py`.

Connected components are vectorized numpy (min-label propagation with
pointer jumping) instead of a per-edge union-find loop; a component's label
is its smallest node, so track ids are a permutation of the JAX package's,
whose union-find roots depend on the union order. The triplet
filter enumerates every triangle of the kept-edge graph at once. The
semantics are the reference's: matched features union into tracks, one
observation per (frame, track) (the first by feature index), an edge in
some triangle survives only if some triangle through it closes within the
threshold.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..geometry.so3 import np_so3_exp


def component_roots(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Label of every node's connected component (the smallest node id in
    it) for the undirected edges (a, b)."""
    label = np.arange(n, dtype=np.int64)
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    while True:
        m = np.minimum(label[a], label[b])
        new = label.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        np.minimum.at(new, label, new)   # pull the smaller label into the root
        new = new[new]                   # pointer jumping
        if np.array_equal(new, label):
            return label
        label = new


class Tracks(NamedTuple):
    num_points: int
    obs_cam: np.ndarray    # (K,) frame index
    obs_feat: np.ndarray   # (K,) feature index within frame
    obs_pt: np.ndarray     # (K,) track (point) id
    track_len: np.ndarray  # (num_points,)


def build_feature_tracks(num_frames: int, num_feats: np.ndarray, pair_i: np.ndarray,
                         pair_j: np.ndarray, idx0: np.ndarray, idx1: np.ndarray,
                         inlier_mask: np.ndarray) -> Tracks:
    """Union inlier matches into tracks (node = frame_offset[f] + feature)."""
    offsets = np.zeros(num_frames + 1, np.int64)
    offsets[1:] = np.cumsum(num_feats)
    total = int(offsets[-1])
    ii = inlier_mask.nonzero()
    a = offsets[pair_i[ii[0]]] + idx0[ii]
    b = offsets[pair_j[ii[0]]] + idx1[ii]
    roots = component_roots(total, a, b)

    touched = np.zeros(total, bool)
    touched[a] = True
    touched[b] = True
    nodes = np.nonzero(touched)[0]
    uniq, pt_ids = np.unique(roots[nodes], return_inverse=True)
    obs_cam = np.searchsorted(offsets, nodes, side="right").astype(np.int32) - 1
    obs_feat = (nodes - offsets[obs_cam]).astype(np.int32)
    obs_pt = pt_ids.astype(np.int32)

    order = np.lexsort((obs_feat, obs_cam, obs_pt))
    oc, of, op = obs_cam[order], obs_feat[order], obs_pt[order]
    first = np.ones(len(order), bool)
    first[1:] = (oc[1:] != oc[:-1]) | (op[1:] != op[:-1])
    oc, of, op = oc[first], of[first], op[first]
    return Tracks(num_points=len(uniq), obs_cam=oc, obs_feat=of, obs_pt=op,
                  track_len=np.bincount(op, minlength=len(uniq)))


def largest_connected_component(num_frames: int, pair_i: np.ndarray,
                                pair_j: np.ndarray, keep: np.ndarray):
    """(frame ids of the largest component ascending, old->new map, −1 outside)."""
    roots = component_roots(num_frames, pair_i[keep], pair_j[keep])
    vals, counts = np.unique(roots, return_counts=True)
    frames = np.nonzero(roots == vals[np.argmax(counts)])[0]
    remap = np.full(num_frames, -1, np.int64)
    remap[frames] = np.arange(len(frames))
    return frames, remap


def filter_triplet_cycles(pair_i: np.ndarray, pair_j: np.ndarray, r_rel: np.ndarray,
                          keep: np.ndarray, thresh_deg: float = 2.0) -> np.ndarray:
    """Drop kept edges that lie in triangles but close no triangle within
    ‖log(R_bc·R_ab·R_acᵀ)‖ < thresh (edges i<j; edges in no triangle stay)."""
    keep = keep.copy()
    kept = np.nonzero(keep)[0]
    if len(kept) == 0:
        return keep
    F = int(max(pair_i.max(), pair_j.max())) + 1
    eid = np.full((F, F), -1, np.int64)
    eid[pair_i[kept], pair_j[kept]] = kept
    adj = eid >= 0
    ea, eb = pair_i[kept].astype(np.int64), pair_j[kept].astype(np.int64)
    # triangles a < b < c led by the kept edge (a, b)
    third = adj[ea] & adj[eb] & (np.arange(F)[None, :] > eb[:, None])
    e_idx, c = np.nonzero(third)
    if len(c) == 0:
        return keep
    p_ab = kept[e_idx]
    p_bc = eid[eb[e_idx], c]
    p_ac = eid[ea[e_idx], c]
    R = np_so3_exp(np.asarray(r_rel, np.float64))
    cyc = np.einsum("tij,tjk->tik", R[p_bc], R[p_ab])
    tr = np.sum(cyc * R[p_ac], axis=(-2, -1))
    err = np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    ok = err < np.deg2rad(thresh_deg)
    tri_edges = np.concatenate([p_ab, p_bc, p_ac])
    in_tri = np.zeros(len(keep), bool)
    in_tri[tri_edges] = True
    consistent = np.zeros(len(keep), bool)
    consistent[tri_edges[np.tile(ok, 3)]] = True
    keep[in_tri & ~consistent] = False
    return keep
