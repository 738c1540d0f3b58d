"""Causal GQA flash attention forward: the CUDA kernel's launch wrapper and
its plain PyTorch version.

``flash_attn_cuda`` launches ``csrc/flash_attn.cu`` (which replaces the
TPU kernel ``repro.kernels.flash_attn.flash_attn.flash_attn_pallas``): one
block per (q tile, head, batch) walking the kv tiles with an fp32 online
softmax, kv tiles no row can see pruned under causality. The source has
two entry points, and ``entry_point`` picks one before the launch: bf16
at hd 128 that TMA tensor maps can describe runs on the tensor cores
(``wgmma``, 128-row q tiles, K/V fed by TMA); fp32, and bf16 at every
other head dim a multiple of 16 up to 256 (stablelm-12b's 160,
whisper-small's 64), on the SIMT kernel (64 x 64 tiles on the CUDA
cores, one compile-time instance per head dim). ``flash_attn_plain`` runs
the blocked
math of the Pallas kernel (``_fa_kernel``) as PyTorch ops, one step per
(q block, kv block) over all batches and heads at once, with the same
block pruning.

Both follow the op's documented contract where the TPU wrapper does not:
kv positions >= T (the wrapper's zero pads) are never attended, and a
query row that sees no key at all (only when S > T + window - 1) is zeros.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

NAME = "flash_attn"
SOURCE = "src/repro_torch/csrc/flash_attn.cu"
REPLACES = "src/repro/kernels/flash_attn/flash_attn.py:83"
HEAD_DIM = 128      # the tensor-core entry's one head dim (see the source)
SIMT_MAX_HD = 256   # the SIMT entry takes every hd a multiple of 16 up to it
_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA, SIMT = "wgmma", "simt"     # the kernel's two entry points


def entry_point(q, k, v) -> str:
    """The entry point that takes (q, k, v): ``WGMMA`` (tensor cores, fed
    by TMA) for bf16 at hd ``HEAD_DIM`` that tensor maps can describe, i.e.
    contiguous tensors on 16-byte boundaries; ``SIMT`` for the rest: fp32
    (``wgmma`` would compute in TF32), bf16 at other head dims, and bf16
    on other strides or bases, which the launch wrapper then refuses as
    the SIMT kernel does."""
    if q.shape[-1] != HEAD_DIM or any(
            t.dtype != torch.bfloat16 or not t.is_contiguous()
            or t.data_ptr() % 16 for t in (q, k, v)):
        return SIMT
    return WGMMA


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attn: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} need "
                         "[B,S,H,hd] and two [B,T,K,hd]")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K < 1 or H % K or T < 1:
        raise ValueError(f"flash_attn: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not match (H % K == 0)")
    return B, S, H, hd, T, K


def flash_attn_plain(q, k, v, *, block_q: int, block_kv: int,
                     causal: bool = True, window: int = 0):
    """Plain version with the TPU kernel's blocks (q padded to ``block_q``
    rows, k/v to ``block_kv`` as the JAX wrapper pads them)."""
    B, S, H, hd, T, K = _shapes(q, k, v)
    G = H // K
    pad_q, pad_kv = (-S) % block_q, (-T) % block_kv
    qf = F.pad(q, (0, 0, 0, 0, 0, pad_q)).float().reshape(B, S + pad_q, K, G,
                                                           hd)
    kf = F.pad(k, (0, 0, 0, 0, 0, pad_kv)).float()
    vf = F.pad(v, (0, 0, 0, 0, 0, pad_kv)).float()
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    out = torch.empty((B, S + pad_q, K, G, hd), dtype=torch.float32,
                      device=dev)
    for q0 in range(0, S + pad_q, block_q):
        qt = qf[:, q0:q0 + block_q]                     # [B, bq, K, G, hd]
        m = torch.full((B, K, G, block_q, 1), _NEG, device=dev)
        l = torch.zeros((B, K, G, block_q, 1), device=dev)
        acc = torch.zeros((B, K, G, block_q, hd), device=dev)
        qp = q0 + torch.arange(block_q, device=dev)[:, None]
        for t0 in range(0, T + pad_kv, block_kv):
            if causal and (t0 > q0 + block_q - 1 or (
                    window and t0 + block_kv <= q0 - window + 1)):
                continue                                # pruned kv block
            kp = t0 + torch.arange(block_kv, device=dev)[None, :]
            s = torch.einsum("bqkgh,btkh->bkgqt", qt,
                             kf[:, t0:t0 + block_kv]) * scale
            mask = kp < T
            if causal:
                mask = mask & (qp >= kp)
                if window:
                    mask = mask & ((qp - kp) < window)
            s = torch.where(mask, s, torch.full_like(s, _NEG))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgqt,btkh->bkgqh", p,
                                             vf[:, t0:t0 + block_kv])
            m = m_new
        o = torch.where(m == _NEG, torch.zeros_like(acc),
                        acc / l.clamp_min(1e-30))
        out[:, q0:q0 + block_q] = o.permute(0, 3, 1, 2, 4)
    return out[:, :S].reshape(B, S, H, hd).to(q.dtype)


def flash_attn_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the CUDA kernel at the entry point ``entry_point`` picks: q
    [B,S,H,hd], k/v [B,T,K,hd], contiguous and 16-byte aligned, one dtype
    (float32 or bfloat16), hd a multiple of 16 up to ``SIMT_MAX_HD``.
    Counts the launch in ``launches`` and in ``by_entry`` under its entry
    point."""
    B, S, H, hd, T, K = _shapes(q, k, v)
    dtype = _DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attn: q/k/v must share float32 or bfloat16, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if hd % 16 or not 16 <= hd <= SIMT_MAX_HD:
        raise ValueError(f"flash_attn: the kernels take a head dim that is a "
                         f"multiple of 16 up to {SIMT_MAX_HD}, got {hd}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attn: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attn: q/k/v must be contiguous and 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    entry = entry_point(q, k, v)
    lib = _build.load(NAME, _bind)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    attend = (int(causal), window if causal else 0, 1.0 / math.sqrt(hd))
    if entry == WGMMA:
        err = lib.flash_attn_tc(*ptrs, B, S, T, H, K, *attend,
                                _build.stream_ptr(q))
    else:
        # fp32, and bf16 at head dims other than 128: every other bf16
        # input the SIMT kernel could take is WGMMA's, and the checks above
        # refuse the rest
        err = lib.flash_attn(*ptrs, B, S, T, H, K, hd, *attend, dtype,
                             _build.stream_ptr(q))
    _build.check(lib, err, f"flash_attn ({entry})")
    flash_attn_cuda.launches += 1
    flash_attn_cuda.by_entry[entry] += 1
    return out


flash_attn_cuda.launches = 0
flash_attn_cuda.by_entry = {WGMMA: 0, SIMT: 0}


def _bind(lib):
    lib.flash_attn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                               + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p])
    lib.flash_attn.restype = ctypes.c_int
    lib.flash_attn_tc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attn_tc.restype = ctypes.c_int
