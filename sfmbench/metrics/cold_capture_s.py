"""cold_capture_s: the wall of the first capture in the process, after the
CUDA context is up and the matcher libraries are loaded."""


def read(rec):
    return rec["cold_capture_s"]
