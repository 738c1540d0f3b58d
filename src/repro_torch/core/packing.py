"""Token-budget ragged packing (paper §3.7) — ``repro.core.packing`` in
PyTorch.

Client segments of different lengths are scattered into a fixed-capacity
``[budget, d]`` buffer with a live-token count; base linears run over the
buffer once (compute ∝ budget, not n_clients × max_len).

PyTorch has no scatter ``mode="drop"`` and no gather ``mode="fill"``: pack
scatters into ``budget + 1`` rows, every dropped token (padding, or past
the budget) aimed at the extra row, which is then cut off; unpack gathers
from the buffer with one zero row appended, every missing token reading
it. Both have fixed shapes and never make the host wait for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Packed(NamedTuple):
    buf: torch.Tensor       # [budget, d]
    seg_ids: torch.Tensor   # [budget] int32, client id per slot (-1 = dead)
    slot_pos: torch.Tensor  # [budget] int32, position within the segment
    lengths: torch.Tensor   # [C] int32
    offsets: torch.Tensor   # [C] int32 (exclusive cumsum of lengths)

    @property
    def live(self):
        return self.seg_ids >= 0


def _slots(lengths, S_max: int, budget: int):
    """(offsets [C], slot of each (client, position) [C*S_max]; a token
    that is padding or past the budget gets slot ``budget``)."""
    lengths = lengths.to(torch.int32)
    offsets = (torch.cumsum(lengths, 0, dtype=torch.int32) - lengths)
    pos = torch.arange(S_max, dtype=torch.int32, device=lengths.device)[None]
    valid = pos < lengths[:, None]
    dest = torch.where(valid, offsets[:, None] + pos, budget)
    return offsets, dest.clamp(max=budget).reshape(-1).long()


def pack(inputs, lengths, budget: int) -> Packed:
    """inputs [C, S_max, d] (padded per client), lengths [C] -> Packed.

    Tokens beyond the budget are dropped (the scheduler sizes the budget so
    this doesn't happen in practice; tests cover the overflow path)."""
    C, S_max, d = inputs.shape
    dev = inputs.device
    lengths = lengths.to(torch.int32)
    offsets, dest = _slots(lengths, S_max, budget)
    buf = torch.zeros((budget + 1, d), dtype=inputs.dtype, device=dev)
    buf[dest] = inputs.reshape(C * S_max, d)
    seg = torch.full((budget + 1,), -1, dtype=torch.int32, device=dev)
    seg[dest] = torch.arange(C, dtype=torch.int32,
                             device=dev).repeat_interleave(S_max)
    slot = torch.zeros((budget + 1,), dtype=torch.int32, device=dev)
    slot[dest] = torch.arange(S_max, dtype=torch.int32, device=dev).repeat(C)
    return Packed(buf=buf[:budget], seg_ids=seg[:budget],
                  slot_pos=slot[:budget], lengths=lengths, offsets=offsets)


def unpack(packed: Packed, buf, S_max: int):
    """Gather a processed [budget, d'] buffer back to [C, S_max, d']."""
    C = packed.lengths.shape[0]
    _, src = _slots(packed.lengths, S_max, buf.shape[0])
    padded = torch.cat([buf, buf.new_zeros((1, buf.shape[-1]))])
    return padded[src].reshape(C, S_max, buf.shape[-1])
