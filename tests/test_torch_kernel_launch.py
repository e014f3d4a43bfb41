"""The one launch path of the port's CUDA kernels (`ops/cuda_libs.Kernel`)
on the CPU, with its C entries and the CUDA stream stood in for: each entry
bound once, launched on the current stream of the tensors' device with the
stream last, a CUDA error raised with the kernel's name; and the tensor
check's verdicts in their order."""

import contextlib
import types

import pytest
import torch

from sphericalsfm_tpu_torch.ops import cuda_libs

torch.set_num_threads(1)


@pytest.fixture
def fake_cuda(monkeypatch):
    """Stand-ins for `bind`, `torch.cuda.device` and the current stream:
    returns the log of binds, device entries and calls."""
    log = dict(binds=[], devices=[], calls=[], errors={})

    def bind(source, entry, argtypes):
        log["binds"].append((source, entry))

        def fn(*args):
            log["calls"].append((entry, args))
            return log["errors"].get(entry, 0)
        return fn

    def device(dev):
        log["devices"].append(dev)
        return contextlib.nullcontext()

    monkeypatch.setattr(cuda_libs, "bind", bind)
    monkeypatch.setattr(cuda_libs.torch.cuda, "device", device)
    monkeypatch.setattr(cuda_libs.torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=("stream", dev)))
    return log


def _kernel():
    return cuda_libs.Kernel("toy", {torch.float64: ("toy.cu", "toy_f64", []),
                                    torch.float32: ("toy.cu", "toy_f32", [])})


def test_launch_binds_each_entry_once_and_passes_the_stream_last(fake_cuda):
    k = _kernel()
    k.launch(torch.float64, "dev0", 1, 2)
    k.launch(torch.float64, "dev0", 3, 4)
    k.launch(torch.float32, "dev1", 5)
    assert fake_cuda["binds"] == [("toy.cu", "toy_f64"), ("toy.cu", "toy_f32")]
    assert fake_cuda["devices"] == ["dev0", "dev0", "dev1"]
    assert fake_cuda["calls"] == [("toy_f64", (1, 2, ("stream", "dev0"))),
                                  ("toy_f64", (3, 4, ("stream", "dev0"))),
                                  ("toy_f32", (5, ("stream", "dev1")))]


def test_launch_raises_naming_the_kernel_and_the_cuda_error(fake_cuda):
    k = _kernel()
    fake_cuda["errors"]["toy_f32"] = 700
    k.launch(torch.float64, "dev0")
    with pytest.raises(RuntimeError, match="toy kernel launch failed: cudaError 700"):
        k.launch(torch.float32, "dev0")


def _specs(a, b, c):
    return dict(a=(a, (2, 3), torch.float64), b=(b, (2,), torch.bool),
                c=(c, (4, 3), torch.float64))


def _ok():
    return torch.zeros(2, 3, dtype=torch.float64), torch.zeros(2, dtype=torch.bool), \
        torch.zeros(4, 3, dtype=torch.float64)


@pytest.mark.parametrize("case,message", [
    ("dtype", "toy takes float32 or float64, got torch.float16"),
    ("device", "c is on meta, a on cpu"),
    ("shape", r"b must be \(2,\) torch.bool, got \(3,\) torch.bool"),
    ("tensor_dtype", r"c must be \(4, 3\) torch.float64, got \(4, 3\) torch.float32"),
    ("contiguous", "a must be contiguous"),
    ("rows", r"toy indexes with int32: sizes \(2, 2147483648\) reach 2\*\*31"),
    ("cpu", "toy takes CUDA tensors, got cpu"),
    # a later tensor's device or shape is named before an earlier one's layout
    ("device_before_layout", "c is on meta, a on cpu"),
    ("shape_before_layout", r"b must be \(2,\)"),
])
def test_check_names_what_the_kernel_does_not_take_in_order(case, message):
    a, b, c = _ok()
    dtype, rows = torch.float64, (2, 12)
    if case == "dtype":
        dtype = torch.float16
    elif case == "device":
        c = c.to("meta")
    elif case == "shape":
        b = torch.zeros(3, dtype=torch.bool)
    elif case == "tensor_dtype":
        c = c.float()
    elif case == "contiguous":
        a = torch.zeros(3, 2, dtype=torch.float64).t()
    elif case == "rows":
        rows = (2, 2 ** 31)
    elif case == "device_before_layout":
        a, c = torch.zeros(3, 2, dtype=torch.float64).t(), c.to("meta")
    elif case == "shape_before_layout":
        a, b = torch.zeros(3, 2, dtype=torch.float64).t(), b[:1]
    with pytest.raises(ValueError, match=message):
        _kernel().check(dtype, _specs(a, b, c), rows)
