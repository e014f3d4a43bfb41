"""The port's CLI verbs of the panorama slice, driven as a user would
(`sphericalsfm_tpu_torch.cli.main`, `--device cpu`) on a tiny rendered
capture written as PNG frames: panorama, circle-views, nerf-export and
evaluate, each held to the JAX package's function on the same files; and
undistort against the JAX package's verb, byte for byte."""

import json
import os

import cv2
import imageio.v2 as iio
import numpy as np
import pytest
import torch

from sphericalsfm_tpu import cli as jax_cli
from sphericalsfm_tpu.eval.relpose_eval import evaluate_models as jax_evaluate_models
from sphericalsfm_tpu.io.nerf import export_nerf as jax_export_nerf
from sphericalsfm_tpu_torch import cli
from sphericalsfm_tpu_torch.eval.render import render_capture

torch.set_num_threads(1)
FOCAL, W, H, F = 120.0, 160, 120, 8


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """PNG frames, poses.txt and intrinsics.txt of an 8-frame full circle."""
    root = tmp_path_factory.mktemp("cli_capture")
    cam_r, cam_t, _, color = render_capture(num_frames=F, arc=1.0, focal=FOCAL, width=W,
                                            height=H, wave_freq=12.5)
    os.makedirs(root / "frames")
    for i, frame in enumerate(color):
        cv2.imwrite(str(root / "frames" / f"{i:06d}.png"), frame)
    with open(root / "poses.txt", "w") as f:
        for i in range(F):
            f.write(f"{i} " + " ".join(f"{v:.15f}" for v in (*cam_t[i], *cam_r[i])) + " \n")
    with open(root / "intrinsics.txt", "w") as f:
        f.write(f"{FOCAL} {W / 2} {H / 2}\n")
    return root


def _run(argv, capsys):
    cli.main(argv)
    return json.loads(capsys.readouterr().out)


def test_panorama_and_circle_views_verbs(capture, tmp_path, capsys):
    common = ["--images", str(capture / "frames" / "%06d.png"), "--poses",
              str(capture / "poses.txt"), "--intrinsics", str(capture / "intrinsics.txt"),
              "--device", "cpu"]
    out = _run(["panorama", *common, "--output", str(tmp_path / "pano"), "--panowidth", "120",
                "--nphi", "3"], capsys)
    assert out == {"output": str(tmp_path / "pano")}
    assert sorted(os.listdir(tmp_path / "pano")) == sorted(
        [f"cylindrical{p}.png" for p in range(3)] + [f"spherical{p}.png" for p in range(3)]
        + ["overunder20.png"])
    cyl = iio.imread(tmp_path / "pano" / "cylindrical1.png")
    assert cyl.shape == (H, 120, 3) and (cyl.sum(axis=(0, 2)) > 0).mean() > 0.8

    out = _run(["circle-views", *common, "--output", str(tmp_path / "views"), "--numviews", "8"],
               capsys)
    assert out["views_written"] >= 4
    assert len(os.listdir(tmp_path / "views")) == out["views_written"]


def test_device_verbs_default_to_cuda(capture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["circle-views", "--images", str(capture / "frames" / "%06d.png"), "--poses",
                  str(capture / "poses.txt"), "--intrinsics", str(capture / "intrinsics.txt"),
                  "--output", str(tmp_path / "views")])


def test_nerf_export_verb(capture, tmp_path, capsys):
    out = _run(["nerf-export", "--poses", str(capture / "poses.txt"), "--calib",
                str(capture / "intrinsics.txt"), "--out", str(tmp_path / "t.json"), "--width",
                str(W), "--height", str(H)], capsys)
    assert out == {"written": str(tmp_path / "t.json")}
    ref = jax_export_nerf(str(capture / "poses.txt"), str(capture / "intrinsics.txt"),
                          str(tmp_path / "j.json"), W, H)
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == json.loads(json.dumps(ref))


def test_evaluate_verb(tmp_path, capsys):
    from tests.test_torch_colmap import _model, write_model

    write_model(str(tmp_path / "pred"), *_model(1, focal=510.0), binary=True)
    write_model(str(tmp_path / "gt"), *_model(2), binary=False)
    out = _run(["evaluate", "--pred", str(tmp_path / "pred"), "--gt", str(tmp_path / "gt")],
               capsys)
    ref = jax_evaluate_models(str(tmp_path / "pred"), str(tmp_path / "gt"))
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("distortion,rotate", [("0.1,-0.05,0.001,0.002", False),
                                               ("-0.2,0.03,0,0,0.01,0,0,0.001", True)])
def test_undistort_matches_jax_verb(distortion, rotate, tmp_path, capsys):
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "in")
    for i in range(3):
        cv2.imwrite(str(tmp_path / "in" / f"f{i:03d}.png"),
                    rng.integers(0, 256, (48, 64, 3)).astype(np.uint8))
    with open(tmp_path / "intr.txt", "w") as f:
        f.write("70.0 31.5 24.25\n")
    outs = {}
    for name, main in (("torch", cli.main), ("jax", jax_cli.main)):
        argv = ["undistort", "--images", str(tmp_path / "in" / "f%03d.png"), "--intrinsics",
                str(tmp_path / "intr.txt"), f"--distortion={distortion}", "--output",
                str(tmp_path / name)] + (["--rotate"] if rotate else [])
        main(argv)
        outs[name] = json.loads(capsys.readouterr().out)
    assert outs["torch"] == outs["jax"] and outs["torch"]["frames"] == 3
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == files and "intrinsics.txt" in files
    for name in files:
        with open(tmp_path / "torch" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
