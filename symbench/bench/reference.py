"""The plain reference: the model written out in fp32 PyTorch, one layer at
a time, with no kernel, cache or batching; a family's feed-forward is
``symbench/refs/<family>.py``.

It imports nothing but ``torch`` and reads only what the benchmark made and
handed to both sides: the configuration file's sizes, the base weights and
the adapters drawn from the seed, the prompts, batches and the tokens the
program served (which it reads only to judge them). Each bf16 weight is
widened to fp32 in the layer that uses it and dropped after it, so the
reference fits beside the base; TF32 is off while it runs.

The mathematics follows the port's transformer, which departs from the
published checkpoints where the configuration file says so (no muP
multipliers on granite, top-k gates renormalized on DeepSeekMoE): RMSNorm
in fp32, split-half RoPE, grouped-query causal attention scaled by
1/sqrt(head_dim), the family's feed-forward (a load-balance loss it gives
weighted by ``aux_loss_alpha``). A LoRA target adds
(alpha / rank) * (x @ A) @ B.

``fp8=True`` is the control: every product of a base weight (not the
router, which the port keeps in fp32, and not the adapters) takes its input
and its weight rounded to float8 e4m3, the input per row and the weight per
output column, each scaled to its largest magnitude.
"""
from __future__ import annotations

import contextlib
import importlib.util
import math
import os
import sys

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


REFS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "refs")


def family_ffn(name: str):
    """The ``ffn(ref, h, p, ad, i)`` of ``refs/<name>.py``."""
    key = f"symbench_refs_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(REFS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key].ffn


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(t, dim):
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in fp32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Model:
    """One configuration's reference over the benchmark's weights.

    ``arch``: the configuration file (Hugging Face key names); ``base``:
    the weights as the benchmark drew them (``embed``, ``final_norm``,
    optional ``lm_head``, and per layer ``ln1``, ``ln2``, ``attn`` with
    ``wq wk wv wo`` [din, dout], and the family's feed-forward weights:
    ``mlp`` with ``gate up down``, or ``moe`` with ``router`` [d, E],
    ``experts`` [E, din, dout] and ``shared``)."""

    def __init__(self, arch: dict, base, fp8: bool = False):
        self.a, self.base, self.fp8 = arch, base, fp8
        self.d = arch["hidden_size"]
        self.H = arch["num_attention_heads"]
        self.K = arch["num_key_value_heads"]
        self.hd = arch.get("head_dim", self.d // self.H)
        self.eps = arch["rms_norm_eps"]
        self.theta = arch["rope_theta"]
        self.ffn = family_ffn(arch["family"])
        self.aux_alpha = arch.get("aux_loss_alpha", 0.0)

    # -- pieces ------------------------------------------------------------
    def linear(self, x, w):
        w = w.float()
        if self.fp8:
            x, w = fp8_round(x, -1), fp8_round(w, -2)
        return x @ w

    def norm(self, x, scale):
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        return x * scale.float()

    def rope(self, x, pos):
        """x [S, n, hd], pos [S]."""
        freqs = self.theta ** (-torch.arange(0, self.hd, 2, device=x.device,
                                             dtype=torch.float32) / self.hd)
        ang = pos[:, None].float() * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    @staticmethod
    def lora(x, leaf, scale):
        return scale * ((x @ leaf[0].float()) @ leaf[1].float())

    def proj(self, x, w, ad, name, i):
        y = self.linear(x, w)
        if ad is not None and name in ad["targets"]:
            A, B = ad["targets"][name]
            y = y + self.lora(x, (A[i], B[i]), ad["scale"])
        return y

    def attention(self, q, k, v, chunk=512):
        """Causal grouped-query attention of one sequence: q [S, H, hd], k,
        v [S, K, hd]; query head h reads KV head h // (H / K)."""
        S = q.shape[0]
        G = self.H // self.K
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
        scale = 1.0 / math.sqrt(self.hd)
        out = []
        keys = torch.arange(S, device=q.device)
        for s in range(0, S, chunk):
            qc = q[s:s + chunk]
            sc = torch.einsum("shd,thd->hst", qc, k) * scale
            rows = torch.arange(s, s + qc.shape[0], device=q.device)
            sc = sc.masked_fill(keys[None, None, :] > rows[None, :, None],
                                float("-inf"))
            out.append(torch.einsum("hst,thd->shd", torch.softmax(sc, -1), v))
        return torch.cat(out, 0)

    def mlp(self, x, p):
        g = self.linear(x, p["gate"])
        u = self.linear(x, p["up"])
        return self.linear(F.silu(g) * u, p["down"])

    def layer(self, x, i, ad):
        """One layer over one sequence x [S, d] -> (x, aux)."""
        p = self.base["layers"][i]
        S = x.shape[0]
        pos = torch.arange(S, device=x.device)
        h = self.norm(x, p["ln1"]["scale"])
        at = p["attn"]
        q = self.proj(h, at["wq"], ad, "q", i).reshape(S, self.H, self.hd)
        k = self.proj(h, at["wk"], ad, "k", i).reshape(S, self.K, self.hd)
        v = self.proj(h, at["wv"], ad, "v", i).reshape(S, self.K, self.hd)
        o = self.attention(self.rope(q, pos), self.rope(k, pos), v)
        x = x + self.proj(o.reshape(S, self.H * self.hd), at["wo"], ad, "o", i)
        y, aux = self.ffn(self, self.norm(x, p["ln2"]["scale"]), p, ad, i)
        return x + y, aux

    def head(self, x):
        x = self.norm(x, self.base["final_norm"]["scale"])
        w = self.base.get("lm_head")
        return self.linear(x, self.base["embed"].T if w is None else w)

    # -- whole passes --------------------------------------------------------
    def hidden(self, tokens, ad):
        """tokens [S] -> final hidden [S, d]."""
        x = self.base["embed"][tokens.long()].float()
        for i in range(len(self.base["layers"])):
            x, _ = self.layer(x, i, ad)
        return x

    def logits_at(self, tokens, positions, ad):
        """Logits [n, V] at ``positions`` of one sequence ``tokens`` [S]."""
        with torch.no_grad():
            return self.head(self.hidden(tokens, ad)[positions])

    def loss(self, batch, ad):
        """A job's loss on ``batch`` (tokens, labels [B, S]): the mean next
        token cross entropy over its B * S labels plus ``aux_loss_alpha`` x
        the MoE layers' load-balance loss over its B * S tokens."""
        xs, aux = self._batch_hidden(batch["tokens"], ad)
        logits = self.head(xs)
        nll = F.cross_entropy(logits, batch["labels"].reshape(-1).long())
        return nll + self.aux_alpha * aux

    def _batch_hidden(self, toks, ad):
        """B sequences through every layer (attention per sequence, the MoE
        routing and its aux loss over all B * S tokens together), each
        layer checkpointed so only its input is held for the backward."""
        B, S = toks.shape
        x = self.base["embed"][toks.long()].float()            # [B, S, d]
        aux = torch.zeros((), device=x.device)
        for i in range(len(self.base["layers"])):
            x, a = torch.utils.checkpoint.checkpoint(
                self._batch_layer, x, i, ad, use_reentrant=False)
            aux = aux + a
        return x.reshape(B * S, -1), aux

    def _batch_layer(self, x, i, ad):
        p = self.base["layers"][i]
        B, S, _ = x.shape
        pos = torch.arange(S, device=x.device)
        at = p["attn"]
        outs = []
        for b in range(B):
            h = self.norm(x[b], p["ln1"]["scale"])
            q = self.proj(h, at["wq"], ad, "q", i).reshape(S, self.H, self.hd)
            k = self.proj(h, at["wk"], ad, "k", i).reshape(S, self.K, self.hd)
            v = self.proj(h, at["wv"], ad, "v", i).reshape(S, self.K, self.hd)
            o = self.attention(self.rope(q, pos), self.rope(k, pos), v)
            outs.append(self.proj(o.reshape(S, -1), at["wo"], ad, "o", i))
        x = x + torch.stack(outs)
        h = self.norm(x, p["ln2"]["scale"]).reshape(B * S, -1)
        y, aux = self.ffn(self, h, p, ad, i)
        return x + y.reshape(B, S, -1), aux


# ---------------------------------------------------------------------------
# fine-tuning: the job's optimizer, written out
# ---------------------------------------------------------------------------

def warmup_cosine(step, lr, warmup, total, min_ratio=0.1):
    if step < warmup:
        return lr * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi
                                                                    * frac)))


def train(model: Model, adapter: dict, scale: float, batches, job: dict):
    """``len(batches)`` AdamW steps of one job from ``adapter`` ({target:
    (A, B)} fp32): returns (losses, the first step's gradients as the
    optimizer takes them (after clipping), the adapter after the last
    step), each leaf keyed (target, "A" | "B")."""
    params = {(t, n): w.detach().float().clone()
              for t, (A, B) in adapter.items() for n, w in (("A", A),
                                                            ("B", B))}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for step, batch in enumerate(batches):
        leaves = {k: p.clone().requires_grad_(True) for k, p in params.items()}
        ad = {"scale": scale, "targets": {
            t: (leaves[(t, "A")], leaves[(t, "B")]) for t in adapter}}
        with torch.enable_grad():
            loss = model.loss(batch, ad)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        g = dict(zip(leaves, grads))
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        clip = job["max_grad_norm"]
        if clip:
            s = torch.clamp(clip / (norm + 1e-9), max=1.0)
            g = {k: x * s for k, x in g.items()}
        if first is None:
            first = {k: x.detach().clone() for k, x in g.items()}
        lr = warmup_cosine(step, job["lr"], job["warmup_steps"],
                           job["total_steps"])
        t = step + 1
        for k in params:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            u = (m[k] / (1 - b1 ** t)) / (torch.sqrt(v2[k] / (1 - b2 ** t))
                                          + eps)
            u = u + job["weight_decay"] * params[k]
            params[k] = params[k] - lr * u
        losses.append(float(loss.detach()))
    return losses, first, params
