"""setup_s: process start to the first measured capture (imports, CUDA
context, kernel libraries, the render, the cold capture)."""


def read(rec):
    return rec["setup_s"]
