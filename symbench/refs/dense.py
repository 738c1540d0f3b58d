"""The dense family's feed-forward in the plain reference: a SwiGLU MLP."""
import torch


def ffn(ref, h, p, ad, i):
    """h [T, d] -> (y [T, d], load-balance loss 0)."""
    return ref.mlp(h, p["mlp"]), torch.zeros((), device=h.device)
