"""The rule that dispatches every kernel op (see ``repro_torch.kernels``).

Kept apart from the package's ``__init__`` so that each ``ops.py`` imports
it without importing the package's re-exports, which import the ``ops.py``
files themselves.
"""
from __future__ import annotations

from contextlib import contextmanager

_PLAIN = False


@contextmanager
def plain_kernels():
    """TEST ORACLE: route every kernel op to its plain PyTorch version, on
    any device. Tests and ``chip_smoke.py`` only."""
    global _PLAIN
    _PLAIN = True
    try:
        yield
    finally:
        _PLAIN = False


def launches_kernel(t) -> bool:
    """True iff an op on tensor ``t`` must launch its CUDA kernel."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return not _PLAIN
