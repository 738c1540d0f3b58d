"""Loss functions (``repro.models.losses``)."""
from __future__ import annotations

import torch


def lm_loss(logits, labels, mask=None, aux=0.0, aux_weight: float = 0.01):
    """Next-token cross entropy, the masked mean over [B, S] in fp32.
    logits [B, S, V] (S may exceed labels' S when a multimodal prefix was
    prepended: the prefix positions are ignored)."""
    S_lab = labels.shape[1]
    S = logits.shape[1]
    if S != S_lab:      # strip the multimodal prefix
        logits = logits[:, S - S_lab:]
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss + aux_weight * aux
