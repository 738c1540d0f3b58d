"""The MoE family's feed-forward in the plain reference: a dense SwiGLU MLP
in the first layers; later, a router in fp32 (its LoRA added) with a
softmax over the experts, the top ``num_experts_per_tok`` by a stable
descending sort, their gates renormalized, each expert run on the tokens
routed to it, the shared experts added, and a Switch-style load-balance
loss E * sum(mean probability * share of assignments)."""
import torch
import torch.nn.functional as F


def ffn(ref, h, p, ad, i):
    """h [T, d] -> (y [T, d], load-balance loss)."""
    if "mlp" in p:
        return ref.mlp(h, p["mlp"]), torch.zeros((), device=h.device)
    p = p["moe"]
    E, topk = ref.a["n_routed_experts"], ref.a["num_experts_per_tok"]
    logits = h @ p["router"].float()
    if ad is not None and "router" in ad["targets"]:
        A, B = ad["targets"]["router"]
        logits = logits + ref.lora(h, (A[i], B[i]), ad["scale"])
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :topk], order[:, :topk]
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    y = torch.zeros_like(h)
    ex = p["experts"]
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        ye = ref.linear(F.silu(ref.linear(xe, ex["gate"][e]))
                        * ref.linear(xe, ex["up"][e]), ex["down"][e])
        y = y.index_add(0, tok, ye * gates[tok, slot][:, None])
    if "shared" in p:
        y = y + ref.mlp(h, p["shared"])
    T = h.shape[0]
    share = torch.zeros(E, device=h.device).index_add(
        0, idx.reshape(-1), torch.ones(T * topk, device=h.device))
    return y, E * torch.sum(probs.mean(0) * share / (T * topk))
