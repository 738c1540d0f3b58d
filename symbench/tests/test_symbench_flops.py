"""The FLOP and byte arithmetic against counts written out by hand."""
import pytest

import tiny
from bench import flops


def test_dense_counts_match_a_hand_count():
    a = tiny.arch("granite-3-8b")        # d 64, 4 heads of 16, 2 KV, ff 128
    m = flops.dims(a)
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64
    mlp = 3 * 64 * 128
    assert flops.base_flops_per_token(m) == 2 * 2 * (attn + mlp)
    assert flops.head_flops(m) == 2 * 64 * 256
    # causal attention over 3 tokens: 1 + 2 + 3 keys, 4 H hd per key, 2 layers
    assert flops.attn_prefill_flops(m, 3) == 2 * 4 * 64 * 6
    assert flops.attn_decode_flops(m, 10) == 2 * 4 * 64 * 10
    lora = flops.lora_flops_per_token(m, ("q", "v"), 8)
    assert lora == 2 * 2 * 8 * ((64 + 64) + (64 + 32))
    assert flops.prefill_flops(m, 3, ((("q", "v"), 8),)) == \
        3 * flops.base_flops_per_token(m) + flops.head_flops(m) \
        + flops.attn_prefill_flops(m, 3) + 3 * lora


def test_moe_counts_the_routed_top_k_and_the_shared_experts():
    a = tiny.arch("deepseek-moe-16b")    # 8 experts of 32, top-2, 2 shared
    m = flops.dims(a)
    attn = 64 * 64 + 2 * 64 * 64 + 64 * 64
    dense = 3 * 64 * 160
    moe = 64 * 8 + 2 * 3 * 64 * 32 + 3 * 64 * (2 * 32)
    assert flops.layer_matmul_params(m, 0) == attn + dense
    assert flops.layer_matmul_params(m, 1) == attn + moe
    # a router target acts on the one MoE layer only
    assert flops.lora_flops_per_token(m, ("router",), 8) == 2 * 8 * (64 + 8)


def test_training_counts_forward_and_input_gradients():
    m = flops.dims(tiny.arch("granite-3-8b"))
    n = 2 * 5
    fwd = n * (flops.base_flops_per_token(m) + flops.head_flops(m))
    lora = n * flops.lora_flops_per_token(m, ("q",), 4)
    attn = 2 * flops.attn_prefill_flops(m, 5)
    assert flops.train_step_flops(m, 2, 5, ("q",), 4) == \
        pytest.approx(2 * fwd + 3 * lora + 3 * attn)


def test_decode_attention_bytes_and_bound():
    m = flops.dims(tiny.arch("granite-3-8b"))     # K 2, hd 16, H 4
    # 20 keys of K and V in bf16, q and out, 3 table entries of 8 tokens
    assert flops.decode_attn_bytes(m, 20, 8) == \
        2 * 20 * 2 * 16 * 2 + 2 * 4 * 16 * 2 + 4 * 3
    pk = flops.peaks("NVIDIA H100 80GB HBM3")
    assert flops.bound_s(3.35e12, 0.0, pk) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 989e12, pk) == pytest.approx(1.0)
    assert flops.peaks("some other card") is None


def test_full_size_counts_match_the_published_sizes():
    from bench import manifest
    man = manifest.load()
    g = flops.dims(manifest.config(man, "granite-3-8b"))
    # 8.17e9 multiplied per token (tied head), 32.7 GFLOP forward + dx
    per_tok = flops.base_flops_per_token(g) + flops.head_flops(g)
    assert per_tok / 2 == pytest.approx(8.17e9, rel=2e-3)
    d = flops.dims(manifest.config(man, "deepseek-moe-16b"))
    active = (flops.base_flops_per_token(d) + flops.head_flops(d)) / 2
    assert active == pytest.approx(2.619e9, rel=1e-3)
