"""The fine-grained MoE family (deepseek-moe-16b): the first
``first_k_dense_replace`` layers keep a dense SwiGLU MLP of
``intermediate_size``; every later layer routes each token, in fp32, to
``num_experts_per_tok`` of ``n_routed_experts`` experts of
``moe_intermediate_size`` and adds ``n_shared_experts`` shared ones. The
program's ``ModelConfig`` for it, its feed-forward weights drawn from the
seed (the router in fp32, as the port keeps it), and the weights one token
multiplies in a layer's feed-forward (routed experts: the top k)."""
import torch


def model_config(arch, m, common):
    from repro_torch.config import MOE, ModelConfig
    return ModelConfig(arch=MOE, n_experts=m.E, top_k=m.topk,
                       n_shared_experts=m.n_shared, d_expert=m.de,
                       first_dense_layers=m.n_dense,
                       moe_every=arch.get("moe_layer_freq", 1),
                       moe_offset=0, **common)


def ffn_weights(arch, m, uni):
    """Per layer {"mlp": ...} for the dense first layers, then {"moe":
    {router, experts, shared}}: each kind drawn for all its layers in one
    call."""
    n_dense, n_moe = m.n_dense, m.L - m.n_dense
    dense = {"gate": uni((n_dense, m.d, m.dff), m.d),
             "up": uni((n_dense, m.d, m.dff), m.d),
             "down": uni((n_dense, m.dff, m.d), m.dff)} if n_dense else {}
    fs = m.n_shared * m.de
    router = uni((n_moe, m.d, m.E), m.d, torch.float32)
    experts = {"gate": uni((n_moe, m.E, m.d, m.de), m.d),
               "up": uni((n_moe, m.E, m.d, m.de), m.d),
               "down": uni((n_moe, m.E, m.de, m.d), m.de)}
    shared = {"gate": uni((n_moe, m.d, fs), m.d),
              "up": uni((n_moe, m.d, fs), m.d),
              "down": uni((n_moe, fs, m.d), fs)} if fs else None
    out = [{"mlp": {k: w[i] for k, w in dense.items()}}
           for i in range(n_dense)]
    for j in range(n_moe):
        moe = {"router": router[j],
               "experts": {k: w[j] for k, w in experts.items()}}
        if shared is not None:
            moe["shared"] = {k: w[j] for k, w in shared.items()}
        out.append({"moe": moe})
    return out


def ffn_matmul_params(m, layer):
    if layer < m.n_dense:
        return 3 * m.d * m.dff
    return m.d * m.E + m.topk * 3 * m.d * m.de + 3 * m.d * m.n_shared * m.de


def router_layers(m):
    """Layers a ``router`` adapter target acts on."""
    return m.L - m.n_dense
