"""One capture through the program: the configuration's driver entry on
frames in memory, a fresh output directory, the written files read back,
and the directory deleted. Also the spans the benchmark puts around the
program's layers when a run is traced."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import tempfile
import time

import torch

# what the scorer and the stage metrics read of a capture's output
OUTPUTS = ("poses.txt", "calib.txt", "stages.jsonl", "sparse/model/images.txt",
           "sparse/model/points3D.txt")
# the driver-level calls that get a span of their own in a traced run
SPANNED_CALLS = ("detect_features", "match_pairs", "estimate_pairwise")


def pipeline_config(config: dict):
    """The program's PipelineConfig from the configuration file's `pipeline`."""
    from sphericalsfm_tpu_torch.config import PipelineConfig

    return PipelineConfig.from_dict(copy.deepcopy(config["pipeline"]))


def sync(device: str):
    if device == "cuda":
        torch.cuda.synchronize()


def run_capture(config: dict, item: dict, cfg, device: str) -> dict:
    """Run the configuration's driver on one pooled capture. The clock runs
    from the driver call to the device synchronise after its files are
    written. Returns {wall, files (path → text), stages}."""
    from sphericalsfm_tpu_torch.geometry.pose import Intrinsics
    from sphericalsfm_tpu_torch.pipeline import driver

    truth = item["truth"]
    W, H = truth["width"], truth["height"]
    out = tempfile.mkdtemp(prefix="sfmbench-")
    try:
        sync(device)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the driver prints each stage
            if config["driver"] == "calibrated":
                driver.run_calibrated(None, Intrinsics(truth["focal"], W / 2.0, H / 2.0), out,
                                      cfg, gray=item["gray"], color=item["color"],
                                      device=device)
            else:
                driver.run_uncalibrated(None, out, cfg, gray=item["gray"], color=item["color"],
                                        device=device)
        sync(device)
        wall = time.perf_counter() - t0
        files = {}
        for rel in OUTPUTS:
            path = os.path.join(out, rel)
            if os.path.exists(path):
                with open(path) as f:
                    files[rel] = f.read()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    stages = [json.loads(ln) for ln in files.pop("stages.jsonl", "").splitlines() if ln]
    return dict(wall=wall, files=files, stages=stages)


@contextlib.contextmanager
def layer_spans():
    """Profiler spans around the program's layers, restored on exit: one
    `stage:<name>` span over each stage the pipeline's StageLogger opens (its
    edges synchronise the device), and one `call:<name>` span around each
    driver-level call in SPANNED_CALLS."""
    from torch.autograd.profiler import record_function

    from sphericalsfm_tpu_torch.pipeline import driver

    base = driver.StageLogger

    class SpannedStageLogger(base):
        def start(self, name):
            super().start(name)
            self._span = record_function(f"stage:{name}")
            self._span.__enter__()

        def end(self, **metrics):
            super().end(**metrics)
            span, self._span = getattr(self, "_span", None), None
            if span is not None:
                span.__exit__(None, None, None)

    def spanned(name, fn):
        def call(*args, **kwargs):
            with record_function(f"call:{name}"):
                return fn(*args, **kwargs)
        return call

    real = {name: getattr(driver, name) for name in SPANNED_CALLS}
    driver.StageLogger = SpannedStageLogger
    for name, fn in real.items():
        setattr(driver, name, spanned(name, fn))
    try:
        yield
    finally:
        driver.StageLogger = base
        for name, fn in real.items():
            setattr(driver, name, fn)
