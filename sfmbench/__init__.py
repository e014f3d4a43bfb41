"""The benchmark of sphericalsfm_tpu_torch on one NVIDIA GPU.

    python3 sfmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every piece is found by name from `BENCHMARK.json`: a cell's configuration
in `configs/<config>.json`, its capture mix in `traffic/<traffic>.json`,
the limits that decide `correct` in `limits/<cell>.json`, and each metric's
reader in `metrics/<metric>.py`. `reference/` holds the frozen renderer and
the scorer; `roofline.py` the published peaks and the matcher's work;
`trace.py` the profiler run and its reduction to spans, busy time and the
breakdown. Nothing here imports jax or the JAX package.
"""
