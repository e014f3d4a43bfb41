"""Profiler spans inside the port, on the clock of the device trace.

`span(name)` is `torch.profiler.record_function(name)` while a profiler
runs and a shared no-op otherwise: with no profiler it costs one flag
check, opens nothing and reads nothing from the device. A span is a
`user_annotation` event in the same trace as the CUDA kernels, so each
idle gap of the device lines up with the host span it falls in. Spans stay
in the profiler's memory; whoever runs the profiler exports them (the
drivers' `cfg.profile_dir`, or a benchmark's own profiler).

Names, each with a dot after the prefix:

* `stage:<layer>.<phase>`, leaves: one phase of the host's work. Leaves
  never nest in one another, so no second is counted twice among them.
* `call:<layer>.<unit>`, containers: one chunk, round or iteration. They
  hold leaves and give counts and seconds per unit.

The one name without a dot is the drivers' `StageLogger` stage,
`stage:<stage>`, opened only under the drivers' own `cfg.profile_dir`
profiler.
"""

from __future__ import annotations

import contextlib

import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: a profiler span `name` while a profiler runs,
    else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
