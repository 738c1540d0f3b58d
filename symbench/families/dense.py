"""The dense family (granite-3-8b): every layer's feed-forward is one
SwiGLU MLP of ``intermediate_size``. The program's ``ModelConfig`` for it,
its feed-forward weights drawn from the seed, and the weights one token
multiplies in a layer's feed-forward."""


def model_config(arch, m, common):
    from repro_torch.config import DENSE, ModelConfig
    return ModelConfig(arch=DENSE, **common)


def ffn_weights(arch, m, uni):
    """Per layer {"mlp": {gate, up, down}}: each kind drawn for all layers
    in one call."""
    w = {"gate": uni((m.L, m.d, m.dff), m.d), "up": uni((m.L, m.d, m.dff), m.d),
         "down": uni((m.L, m.dff, m.d), m.dff)}
    return [{"mlp": {k: v[i] for k, v in w.items()}} for i in range(m.L)]


def ffn_matmul_params(m, layer):
    return 3 * m.d * m.dff


def router_layers(m):
    return 0
