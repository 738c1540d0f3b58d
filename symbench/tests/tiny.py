"""Tiny stand-ins of the benchmark's configurations and mixes for the CPU
tests: the same families, keys and loops at a few hundred thousand
parameters, fp32 or bf16, and seconds-long windows."""
from __future__ import annotations

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def arch(name: str, dtype: str = "float32") -> dict:
    a = _load("configs", f"{name}.json")
    a.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             head_dim=16, vocab_size=256, torch_dtype=dtype)
    a["num_key_value_heads"] = 2 if a["family"] == "dense" else 4
    if a["family"] == "moe":
        a.update(intermediate_size=160, moe_intermediate_size=32,
                 n_routed_experts=8, num_experts_per_tok=2)
    else:
        a["intermediate_size"] = 128
    kv = 2 * a["num_hidden_layers"] * a["num_key_value_heads"] * 16 * 4
    a["serve"] = dict(a["serve"], page_block=8, kv_bytes_per_token=kv,
                      kv_budget_bytes=kv * 8 * 48 * 4)
    return a


def serve_mix(loop: str) -> dict:
    """A tiny serving mix for ``loop`` (``serve_open`` or
    ``serve_backlog``): 4 tenants x 2 slots of a rank-8 LoRA bank, short
    lognormal prompts and outputs, greedy. No serving cell is in
    ``BENCHMARK.json`` yet; these keep the serving loops and their readers
    tested for the cells that will add one."""
    m = {"loop": loop, "tenants": 4, "slots_per_tenant": 2,
         "tenants_order": "uniform" if loop == "serve_open"
         else "round_robin",
         "bank": {"method": "lora", "rank": 8, "alpha": 16.0,
                  "targets": ["q", "v"] if loop == "serve_open"
                  else ["q", "v", "router"], "b_scale": 0.05},
         "max_seq": 64, "policy": "opportunistic", "shape_seed": 5,
         "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.8,
                    "min": 4, "max": 40},
         "output": {"dist": "lognormal", "median": 6, "sigma": 0.8,
                    "min": 3, "max": 16},
         "warm": {"rows": 2, "prompt_lengths": [8, 16, 32, 40]},
         "check": {"served_tokens": 20, "max_requests": 3,
                   "watched_share": 0.6},
         "kernels": ["decode_attn", "sgmv"]}
    if loop == "serve_open":
        m.update(fill_seconds=1.0, arrivals={"rate_per_s": 20.0})
    else:
        m.update(backlog={"requests": 400}, admit_per_tick=2,
                 max_fill_seconds=60)
    return m


def train_mix(name: str) -> dict:
    m = copy.deepcopy(_load("traffic", f"{name}.json"))
    m.update(batch=2, seq=16, trace_ticks=1)
    for b in m["banks"]:
        b["jobs"] = 2
    return m
