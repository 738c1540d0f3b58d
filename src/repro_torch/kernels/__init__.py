"""Hand-written Hopper kernels of the port, and the rule that dispatches them.

Each kernel keeps the JAX package's split under ``kernels/<name>/``:
``<name>.py`` holds the CUDA launch wrapper (with its launch count) and the
kernel's plain PyTorch version, ``ops.py`` dispatches, ``ref.py`` is the
un-blocked oracle. The CUDA sources live in ``repro_torch/csrc/`` and are
built by ``kernels/_build.py`` at first use.

Dispatch, the same in every ``ops.py``: a tensor on the CPU runs the plain
version; a CUDA tensor launches the kernel, and a failed build or launch
raises. There is no fallback and no environment switch. The one exception
is the test oracle ``plain_kernels()`` (re-exported by ``models.blocks``),
which routes every op to its plain version so a test or ``chip_smoke.py``
can compare the kernels' model-level output against it on the card.
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
