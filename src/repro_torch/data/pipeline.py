"""Deterministic synthetic LM data pipeline (``repro.data.pipeline``).

Deterministic per-(client, step) streams with a learnable order-1 Markov
structure, so fine-tuning loss decreases. The tokens are drawn with numpy
exactly as the JAX package draws them, so both give the same batches bit
for bit; the port hands them over as torch tensors on the caller's device.
A VLM's image frontend and an encoder-decoder's audio frontend are
stubbed (``frontend_stub``, the one allowed stub) and
``make_client_batches`` composes them into the family's batches, as
JAX's does; their draw is the port's own (JAX draws it from ``jax.random``),
so a test that holds the port against JAX hands JAX's draw over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ENCDEC, VLM, ModelConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    """Per-client deterministic token streams with learnable structure.

    Each client c draws from its own order-1 Markov chain (one preferred
    successor per token, drawn from ``seed``), giving every fine-tuning job
    a distinct "task"."""
    vocab: int
    seq_len: int
    n_clients: int
    batch_per_client: int
    seed: int = 0
    structure: float = 0.8     # prob mass on the preferred next-token
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        # one preferred-successor table per client: vocab -> vocab
        self.succ = rng.integers(0, self.vocab, size=(self.n_clients, self.vocab))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """tokens/labels int32 [C, B, S] for one step, on ``device``."""
        C, B, S, V = self.n_clients, self.batch_per_client, self.seq_len, self.vocab
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((C, B, S + 1), np.int32)
        toks[:, :, 0] = rng.integers(0, V, size=(C, B))
        rand = rng.random((C, B, S))
        noise = rng.integers(0, V, size=(C, B, S))
        for t in range(S):
            preferred = np.take_along_axis(
                self.succ, toks[:, :, t].reshape(C, -1), axis=1).reshape(C, B)
            toks[:, :, t + 1] = np.where(rand[:, :, t] < self.structure,
                                         preferred, noise[:, :, t])
        return {"tokens": torch.tensor(toks[:, :, :-1], device=self.device),
                "labels": torch.tensor(toks[:, :, 1:], device=self.device)}


def frontend_stub(cfg: ModelConfig, n_clients: int, batch: int, *,
                  generator: torch.Generator,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Precomputed modality-frontend embeddings (the one allowed stub), [C,
    B, n_frontend_tokens, d] in ``cfg.dtype``, normal * 0.02 drawn from
    ``generator`` (which must live on ``device``): an encoder-decoder's
    mel + conv frame embeddings ``frames``, a VLM's ViT/projector anyres
    patch embeddings ``img_embed``; other families get none. JAX's
    ``frontend_stub`` draws from ``PRNGKey(seed)``; its draw crosses over
    through ``convert.tensor_from_numpy``."""
    name = {ENCDEC: "frames", VLM: "img_embed"}.get(cfg.arch)
    if name is None:
        return {}
    dev = resolve_device(device)
    emb = torch.randn((n_clients, batch, cfg.n_frontend_tokens, cfg.d_model),
                      generator=generator, dtype=torch.float32, device=dev)
    return {name: (emb * 0.02).to(getattr(torch, cfg.dtype))}


def make_client_batches(cfg: ModelConfig, n_clients: int,
                        batch_per_client: int, seq_len: int, *, seed: int = 0,
                        device="cuda") -> "ClientBatchStream":
    """Dataset + frontend stub composed per model family: an
    encoder-decoder's batches also carry ``frames`` and a VLM's
    ``img_embed``, [C, B, n_frontend_tokens, d], drawn once from
    ``seed`` on the host (the same bits on every device) and handed out
    with every step, as JAX's static stand-in."""
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq_len,
                            n_clients=n_clients,
                            batch_per_client=batch_per_client, seed=seed,
                            device=device)
    extra = frontend_stub(cfg, n_clients, batch_per_client,
                          generator=torch.Generator().manual_seed(seed),
                          device="cpu")
    return ClientBatchStream(ds, {k: v.to(ds.device)
                                  for k, v in extra.items()})


class ClientBatchStream:
    def __init__(self, ds: SyntheticLMDataset, extra: Dict[str, torch.Tensor]):
        self.ds = ds
        self.extra = extra

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        b = self.ds.batch(step)
        b.update(self.extra)     # frontend embeddings are static stand-ins
        return b
