"""The one generator of captures: a traffic file, the configuration's
frame count and a seed → a pool of rendered captures; and the matching
problem a capture posed.

A traffic file holds the camera and the scene: `width`, `height`, the
true `focal`, `inward`, the texture (`waves`, `freq`, `arc`) and `pool`,
the number of distinct captures the window cycles through. The number of
frames is the configuration's (its scale). Every seed renders the same
sizes; only the scene's random texture changes with the seed.
"""

from __future__ import annotations

import numpy as np

from .reference.render import render_capture


def render_seeds(seed: int, pool: int) -> list:
    """The renderer's seeds of the pool, drawn from the run's seed (any
    whole number, of any size or sign)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(v) for v in np.random.default_rng(ss).integers(0, 2 ** 62, pool)]


def make_pool(traffic: dict, frames: int, seed: int, device) -> list:
    """[{seed, gray, color, truth}] for the traffic's pool of `frames`-frame
    captures, rendered on `device` by the benchmark's frozen renderer."""
    pool = []
    for s in render_seeds(seed, int(traffic.get("pool", 2))):
        cam_r, cam_t, gray, color = render_capture(
            int(frames), float(traffic["focal"]), int(traffic["width"]),
            int(traffic["height"]), s, inward=bool(traffic.get("inward", False)),
            n_waves=int(traffic.get("waves", 600)), wave_freq=float(traffic.get("freq", 50.0)),
            arc=float(traffic.get("arc", 1.0)), device=device)
        pool.append(dict(seed=s, gray=gray, color=color, truth=dict(
            cam_r=cam_r, cam_t=cam_t, focal=float(traffic["focal"]),
            width=int(traffic["width"]), height=int(traffic["height"]))))
    return pool


def matching_problem(config: dict, stages: list):
    """The matcher's problem of one capture: frames, the pairs the program
    matched (its `match_pairs` stage's count), keypoints a frame (the
    padded table's width), descriptor length. None where the capture
    logged no matching."""
    pairs = [s["pairs"] for s in stages if s.get("stage") == "match_pairs" and "pairs" in s]
    if not pairs:
        return None
    return dict(frames=int(config["frames"]), pairs=int(pairs[-1]), dim=128,
                keypoints=int(config["pipeline"]["frontend"]["max_keypoints"]))
