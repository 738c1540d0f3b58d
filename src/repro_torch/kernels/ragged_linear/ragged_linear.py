"""Token-packed frozen base linear: the CUDA kernel's launch wrapper and its
plain PyTorch version.

``ragged_linear_cuda`` launches ``csrc/ragged_linear.cu`` (which replaces
the TPU kernel ``repro.kernels.ragged_linear.ragged_linear.
ragged_linear_pallas``): ``buf [budget, din] @ w [din, dout] + b`` with
fp32 accumulation, row tiles wholly past the live count skipped and rows
``>= n_live`` written as exact zeros. The source has two entry points, and
``entry_point`` picks one from dtype, strides and alignment before the
launch: bf16 that a TMA tensor map can describe runs on the tensor cores
(``wgmma``), the rest (fp32, other row strides or bases) on the SIMT
kernel. ``ragged_linear_plain`` runs the blocked math of the Pallas kernel
(``_rl_kernel``) as PyTorch ops: token tile x dout tile x din tile, the
fp32 sum carried over the din tiles, a tile with no live row left at zero,
then the bias and the zeroed tail. Neither pads: shapes are used as given.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "ragged_linear"
SOURCE = "src/repro_torch/csrc/ragged_linear.cu"
REPLACES = "src/repro/kernels/ragged_linear/ragged_linear.py:54"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA, SIMT = "wgmma", "simt"     # the kernel's two entry points


def entry_point(buf, w) -> str:
    """The entry point that takes (buf, w): ``WGMMA`` (tensor cores, fed
    by TMA) for bf16 whose rows a tensor map can describe, i.e. row strides
    of buf and w that are multiples of 16 bytes and bases on 16-byte
    boundaries; ``SIMT`` for the rest: fp32 (``wgmma`` would compute in
    TF32) and bf16 on other strides or bases."""
    if buf.dtype != torch.bfloat16:
        return SIMT
    if any(t.stride(0) * t.element_size() % 16 or t.data_ptr() % 16
           for t in (buf, w)):
        return SIMT
    return WGMMA


def _shapes(buf, w, b):
    if buf.ndim != 2 or w.ndim != 2 or w.shape[0] != buf.shape[1]:
        raise ValueError(f"ragged_linear: buf {tuple(buf.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    budget, din = buf.shape
    dout = w.shape[1]
    if b is not None and tuple(b.shape) != (dout,):
        raise ValueError(f"ragged_linear: bias {tuple(b.shape)} needs "
                         f"({dout},)")
    return budget, din, dout


def _tiles(budget: int, din: int, dout: int, block_t: int = 256,
          block_d: int = 512, block_k: int = 512):
    """The JAX wrapper's tiles (``ragged_linear/ops.py:36-38``)."""
    return (min(block_t, max(8, budget)), min(block_d, max(128, dout)),
            min(block_k, max(128, din)))


def ragged_linear_plain(buf, w, b=None, n_live=None, *, block_t: int = 256,
                        block_d: int = 512, block_k: int = 512):
    """Plain version: the Pallas kernel's tiles, one step per (token tile,
    dout tile, din tile). ``n_live`` (None = all rows) may be an int or a
    0-d integer tensor on ``buf``'s device; it is never read on the host."""
    budget, din, dout = _shapes(buf, w, b)
    n = torch.as_tensor(budget if n_live is None else n_live,
                        device=buf.device)
    bt, bd, bk = _tiles(budget, din, dout, block_t, block_d, block_k)
    y = torch.empty((budget, dout), dtype=buf.dtype, device=buf.device)
    for t0 in range(0, budget, bt):
        x = buf[t0:t0 + bt].float()
        live = t0 < n                        # any live row in this tile?
        row_live = (t0 + torch.arange(x.shape[0], device=buf.device)
                    < n)[:, None]
        for d0 in range(0, dout, bd):
            acc = torch.zeros((x.shape[0], min(bd, dout - d0)),
                              dtype=torch.float32, device=buf.device)
            for k0 in range(0, din, bk):
                step = x[:, k0:k0 + bk] @ w[k0:k0 + bk, d0:d0 + bd].float()
                acc = torch.where(live, acc + step, acc)
            if b is not None:
                acc = acc + b[d0:d0 + bd].float()
            y[t0:t0 + bt, d0:d0 + bd] = torch.where(
                row_live, acc, torch.zeros_like(acc)).to(buf.dtype)
    return y


def ragged_linear_cuda(buf, w, b=None, n_live=None):
    """Launch the CUDA kernel at the entry point ``entry_point`` picks. buf
    must be contiguous; w may be a view whose rows are strided (its
    columns contiguous). ``n_live`` (None = all rows) is an int, passed by
    value, or a 0-d integer tensor on the card, which the kernel reads
    from device memory (the host never waits for it). Counts the launch in
    ``launches`` and in ``by_entry`` under its entry point."""
    budget, din, dout = _shapes(buf, w, b)
    dtype = _DTYPES.get(buf.dtype)
    if dtype is None or w.dtype != buf.dtype or (
            b is not None and b.dtype != buf.dtype):
        raise TypeError(f"ragged_linear: buf/w/b must share float32 or "
                        f"bfloat16, got {buf.dtype}/{w.dtype}/"
                        f"{None if b is None else b.dtype}")
    tensors = [t for t in (w, b, n_live) if isinstance(t, torch.Tensor)]
    if not (buf.is_cuda and all(t.device == buf.device for t in tensors)):
        raise ValueError("ragged_linear: all tensors must be on one CUDA "
                         "device")
    if not buf.is_contiguous() or w.stride(1) != 1 or (
            b is not None and not b.is_contiguous()):
        raise ValueError("ragged_linear: buf and b must be contiguous and "
                         "w's rows unit-stride")
    n_dev, n_host = None, budget
    if isinstance(n_live, torch.Tensor):
        if n_live.ndim != 0 or n_live.is_floating_point():
            raise ValueError(f"ragged_linear: n_live must be a 0-d integer "
                             f"tensor, got {n_live.dtype} "
                             f"{tuple(n_live.shape)}")
        n_dev = n_live.to(torch.int32)
    elif n_live is not None:
        n_host = max(0, min(int(n_live), budget))
    y = torch.empty((budget, dout), dtype=buf.dtype, device=buf.device)
    entry = entry_point(buf, w)
    lib = _build.load(NAME, _bind)
    args = (buf.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            None if n_dev is None else n_dev.data_ptr(), n_host, y.data_ptr(),
            budget, din, dout, w.stride(0))
    if entry == WGMMA:
        err = lib.ragged_linear_tc(*args, _build.stream_ptr(buf))
    else:
        err = lib.ragged_linear(*args, dtype, _build.stream_ptr(buf))
    _build.check(lib, err, f"ragged_linear ({entry})")
    ragged_linear_cuda.launches += 1
    ragged_linear_cuda.by_entry[entry] += 1
    return y


ragged_linear_cuda.launches = 0
ragged_linear_cuda.by_entry = {WGMMA: 0, SIMT: 0}


def _bind(lib):
    head = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_longlong])
    lib.ragged_linear.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
    lib.ragged_linear.restype = ctypes.c_int
    lib.ragged_linear_tc.argtypes = head + [ctypes.c_void_p]
    lib.ragged_linear_tc.restype = ctypes.c_int
