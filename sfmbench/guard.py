"""The check that nothing of JAX was loaded: top-level module names are
compared whole, so `sphericalsfm_tpu_torch` passes where
`sphericalsfm_tpu` and `sphericalsfm_tpu.x` do not."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sphericalsfm_tpu"})


def forbidden_modules(names=None) -> list:
    """The loaded module names whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
