"""Hand-written Hopper kernels of the port, and the rule that dispatches them.

The public ops are the JAX package's (``repro.kernels``), with the same
contracts: ``sgmv``, ``ragged_linear``, ``decode_attn`` (dense cache, or
paged with ``block_tbl=``) and ``flash_attn``, each with its un-blocked
oracle ``*_ref``.

Each kernel keeps the JAX package's split under ``kernels/<name>/``:
``<name>.py`` holds the CUDA launch wrapper (with its launch count) and the
kernel's plain PyTorch version, ``ops.py`` dispatches, ``ref.py`` is the
un-blocked oracle. The CUDA sources live in ``repro_torch/csrc/`` and are
built by ``kernels/_build.py`` at first use.

Dispatch (``kernels/_dispatch.py``), the same in every ``ops.py``: a tensor
on the CPU runs the plain version; a CUDA tensor launches the kernel, and a
failed build or launch raises. There is no fallback and no environment
switch. The one exception is the test oracle ``plain_kernels()``
(re-exported by ``models.blocks``), which routes every op to its plain
version so a test or ``chip_smoke.py`` can compare the kernels'
model-level output against it on the card.

As in the JAX package, the op names shadow their subpackages as attributes
of this package: reach a subpackage's other names through
``from repro_torch.kernels.<name> import ...``.
"""
from repro_torch.kernels._dispatch import launches_kernel, plain_kernels
from repro_torch.kernels.sgmv import sgmv, sgmv_ref
from repro_torch.kernels.ragged_linear import ragged_linear, ragged_linear_ref
from repro_torch.kernels.decode_attn import decode_attn, decode_attn_ref
from repro_torch.kernels.flash_attn import flash_attn, flash_attn_ref

__all__ = ["decode_attn", "decode_attn_ref", "flash_attn", "flash_attn_ref",
           "launches_kernel", "plain_kernels", "ragged_linear",
           "ragged_linear_ref", "sgmv", "sgmv_ref"]
