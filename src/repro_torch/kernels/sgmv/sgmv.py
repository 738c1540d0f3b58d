"""SGMV: the CUDA kernel's launch wrapper and its plain PyTorch version.

``sgmv_cuda`` launches ``csrc/sgmv.cu`` (which replaces the TPU kernel
``repro.kernels.sgmv.sgmv.sgmv_pallas_safe``); ``sgmv_plain`` runs the same
blocked math as PyTorch ops, one step per token block like the JAX twin
``sgmv_stream``. Block i computes ``y_i = (x_i @ A[id_i]) @ B[id_i] * scale``
in fp32; ``id < 0`` gives zeros; ids are clamped before they address A/B.
As the JAX op (which pads x and the ids), both take any T: the last block
may be short, and a block with no id (at or past ``len(block_adapter)``)
is dead. Neither pads: rows past T are neither read nor written, and the
rank and dout are used as given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "sgmv"
SOURCE = "src/repro_torch/csrc/sgmv.cu"
REPLACES = "src/repro/kernels/sgmv/sgmv.py:115"
# the kernel's tile: columns per block at decode (block_t 1, one token per
# block) and, with block_t > 1, tokens and columns per block; the fastest
# at the serving path's shapes (tools/kernel_sweeps.py)
DECODE_COLS = 256
PREFILL_TOKENS = 4
PREFILL_COLS = 4096
MAX_RANK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(x, A, B, block_adapter, block_t):
    """(T, din, n, r, dout, nb): nb = ceil(T / block_t) token blocks, of
    which the first ``len(block_adapter)`` have ids."""
    T, din = x.shape
    n, din_a, r = A.shape
    if din_a != din or B.shape[:2] != (n, r):
        raise ValueError(f"sgmv: x {tuple(x.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)} do not chain")
    if block_t < 1:
        raise ValueError(f"sgmv: block_t {block_t} < 1")
    nb = -(-T // block_t)
    if block_adapter.ndim != 1 or block_adapter.shape[0] > nb:
        raise ValueError(f"sgmv: {T} tokens in blocks of {block_t} take at "
                         f"most {nb} ids, got {tuple(block_adapter.shape)}")
    return T, din, n, r, B.shape[-1], nb


def sgmv_plain(x, A, B, block_adapter, *, block_t: int, scale: float = 1.0):
    """Plain version: one step per token block, each gathering its block's
    adapter and running the kernel's two fp32 products; blocks without an
    id are zeros."""
    T, din, n, r, dout, nb = _shapes(x, A, B, block_adapter, block_t)
    safe = block_adapter.long().clamp(0, n - 1)
    out = []
    for i in range(nb):
        xi = x[i * block_t:(i + 1) * block_t].float()
        zeros = xi.new_zeros((xi.shape[0], dout))
        if i >= block_adapter.shape[0]:
            out.append(zeros)
            continue
        h = xi @ A[safe[i]].float()
        y = (h @ B[safe[i]].float()) * scale
        out.append(torch.where(block_adapter[i] >= 0, y, zeros))
    if not out:
        return x.new_zeros((T, dout))
    return torch.cat(out).to(x.dtype)


def sgmv_cuda(x, A, B, block_adapter, *, block_t: int, scale: float = 1.0):
    """Launch the CUDA kernel: one block per (token tile of one adapter
    block, dout tile). A and B may be strided along their client axis
    (layer-major views of a bank); each client's [din, r] / [r, dout]
    matrix must be row-major."""
    T, din, n, r, dout, nb = _shapes(x, A, B, block_adapter, block_t)
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or A.dtype != x.dtype or B.dtype != x.dtype:
        raise TypeError(f"sgmv: x/A/B must share float32 or bfloat16, got "
                        f"{x.dtype}/{A.dtype}/{B.dtype}")
    if not (x.is_cuda and A.device == x.device and B.device == x.device
            and block_adapter.device == x.device):
        raise ValueError("sgmv: all tensors must be on one CUDA device")
    if not x.is_contiguous() or A.stride()[1:] != (r, 1) \
            or B.stride()[1:] != (dout, 1):
        raise ValueError("sgmv: x must be contiguous and each client's A/B "
                         "matrix row-major")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"sgmv: rank {r} outside [1, {MAX_RANK}]")
    ids = block_adapter.to(torch.int32).contiguous()
    y = torch.empty((T, dout), dtype=x.dtype, device=x.device)
    tokens, cols = ((1, DECODE_COLS) if block_t == 1
                    else (PREFILL_TOKENS, PREFILL_COLS))
    lib = _build.load(NAME, _bind)
    err = lib.sgmv(x.data_ptr(), A.data_ptr(), B.data_ptr(), ids.data_ptr(),
                   y.data_ptr(), T, din, r, dout, n, ids.numel(), block_t,
                   tokens, cols, A.stride(0), B.stride(0), scale, dtype,
                   _build.stream_ptr(x))
    _build.check(lib, err, "sgmv")
    sgmv_cuda.launches += 1
    return y


sgmv_cuda.launches = 0


def _bind(lib):
    lib.sgmv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                         + [ctypes.c_longlong] * 2
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.sgmv.restype = ctypes.c_int
