"""PyTorch port vs the JAX reference: the MoE family's modules and the VLM
branch of the model, on the CPU.

Checked on ``tiny(MOE)`` (3 layers, the first dense, 4 experts top-2, 1
shared expert) and ``tiny(VLM)`` (8 image tokens), fp32, with weights
drawn by the JAX package's own init and inputs by numpy from seeds, passed
to both packages through ``convert``:

* ``moe_forward``: scatter and einsum dispatch, drop-free and at a
  dropping ``capacity_factor``, with and without a shared expert: outputs
  and the aux loss at atol = rtol = 1e-5; the port's two dispatches agree;
  top-k ties (a zero hidden state, duplicated router columns) pick the
  experts JAX picks;
* ``frozen_expert``: dx against JAX's ``custom_vjp`` at 1e-5, the weight
  its only saved tensor;
* ``forward`` (logits at 1e-4, aux at 1e-5) on the tiny configs and on the
  reduced deepseek-moe-16b, arctic-480b (dense residual, head_pad) and
  llava-next-mistral-7b; ``prefill`` then ``decode_step`` on paged and
  dense caches (int8 too), a VLM image prefix among them, caches carried
  back to JAX's layout by ``convert`` (pools at 1e-5);
* ``convert`` round trips of MoE params, banks and caches; the configs,
  ``reduced()``, cache sizing, adapter targets and bytes against JAX's;
  ``frontend_stub``; fine-tuning of both families through the engine and
  the train CLI, and what is still refused (hybrid, recurrent,
  encoder-decoder).

Tier-1 runs the tiny configs and one cache layout per family; the reduced
deepseek, arctic and llava forwards and the other layouts run under
``-m tier2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, ENCDEC, MOE, VLM
from repro.configs import get_config as jax_get_config
from repro.core import adapters as jax_adapters
from repro.core import symbiosis as jax_sym
from repro.core.frozen_linear import frozen_expert as jax_frozen_expert
from repro.data.pipeline import frontend_stub as jax_frontend_stub
from repro.models import blocks as jax_blocks
from repro.models import get_model as jax_get_model
from repro.models import moe as jax_moe
from repro.serving import kvcache as jax_kvcache
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.frozen_linear import frozen_expert
from repro_torch.data import frontend_stub
from repro_torch.models import blocks as port_blocks
from repro_torch.models import get_model
from repro_torch.models import moe as port_moe
from repro_torch.serving import kvcache as port_kvcache
from repro_torch.training import FinetuneEngine
from conftest import tiny
from test_torch_mixed_serving import port_acfg
from test_torch_model import LOGIT_TOL, POOL_TOL, port_config

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("deepseek-moe-16b", "arctic-480b", "llava-next-mistral-7b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.array, tree)      # writable copies


def _layer(rng, cfg, moe):
    """One layer's params in the JAX layout, numpy draws from the JAX
    init's distributions (norm scales jittered around 1)."""
    d, hd, E, fe = cfg.d_model, cfg.hd, cfg.n_experts, cfg.ffn_hidden

    def lin(din, dout, lead=()):
        s = 1.0 / np.sqrt(din)
        return rng.uniform(-s, s, lead + (din, dout)).astype(np.float32)

    def mlp(f):
        return {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)}

    def norm():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)}
    p = {"ln1": norm(), "ln2": norm(),
         "attn": {"wq": lin(d, cfg.hp * hd), "wk": lin(d, cfg.n_kv_heads * hd),
                  "wv": lin(d, cfg.n_kv_heads * hd), "wo": lin(cfg.hp * hd, d)}}
    if not moe:
        p["mlp"] = mlp(cfg.d_ff)
        return p
    p["moe"] = {"router": lin(d, E),
                "experts": {"gate": lin(d, fe, (E,)), "up": lin(d, fe, (E,)),
                            "down": lin(fe, d, (E,))}}
    if cfg.n_shared_experts:
        p["moe"]["shared"] = mlp(fe * cfg.n_shared_experts)
    if cfg.dense_residual:
        p["mlp"] = mlp(cfg.d_ff)
    return p


def numpy_params(cfg, seed):
    """Base params in the JAX layout (MoE stacks, the ``pre_layers``
    list), drawn by numpy; the tree's structure and shapes are JAX's
    ``init_params``' (checked against its ``eval_shape``)."""
    rng = np.random.default_rng(seed)
    n_pre = cfg.first_dense_layers
    moe = bool(cfg.n_experts) and cfg.is_moe_layer(n_pre)
    scan = [_layer(rng, cfg, moe) for _ in range(cfg.n_layers - n_pre)]
    tree = {"embed": (rng.standard_normal((cfg.vocab, cfg.d_model)) * 0.02)
            .astype(np.float32),
            "final_norm": {"scale": np.ones(cfg.d_model, np.float32)},
            "lm_head": rng.uniform(-0.1, 0.1, (cfg.d_model, cfg.vocab))
            .astype(np.float32),
            "layers": jax.tree.map(lambda *a: np.stack(a), *scan)}
    if n_pre:
        tree["pre_layers"] = [_layer(rng, cfg, False) for _ in range(n_pre)]
    want = jax.eval_shape(lambda: jax_get_model(cfg).init_params(
        jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(tree)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return tree


def numpy_bank(cfg, acfg, n_clients, seed):
    """A client-stacked bank in the PORT's layout ([C, L, ...] over every
    layer), every leaf non-trivial (LoRA B non-zero, IA3 scales around
    1, prefix K/V large enough to move the logits)."""
    rng = np.random.default_rng(seed)
    C, L = n_clients, cfg.n_layers
    if acfg.method == "prefix":
        shape = (C, L, acfg.n_prefix, cfg.n_kv_heads, cfg.hd)
        return {"layers": {n: rng.standard_normal(shape).astype(np.float32)
                           for n in ("prefix_k", "prefix_v")}}
    out = {}
    for path, (din, dout) in jax_adapters.resolve_targets(cfg, acfg):
        if acfg.method == "lora":
            out[path] = {
                "A": (rng.standard_normal((C, L, din, acfg.rank))
                      / np.sqrt(din)).astype(np.float32),
                "B": (rng.standard_normal((C, L, acfg.rank, dout)) * 0.5)
                .astype(np.float32)}
        else:
            n = din if path == "down" else dout
            out[path] = {"scale": (1.0 + 0.3 * rng.standard_normal((C, L, n)))
                         .astype(np.float32)}
    return {"layers": out}


def jax_bank(cfg, bank):
    """A port-layout numpy bank in JAX's layout: the first
    ``first_dense_layers`` layers split off as ``pre_layers``."""
    n = cfg.first_dense_layers
    if not n:
        return bank
    return {"layers": jax.tree.map(lambda a: a[:, n:], bank["layers"]),
            "pre_layers": [jax.tree.map(lambda a, i=i: a[:, i],
                                        bank["layers"]) for i in range(n)]}


def reduced(arch):
    return jax_get_config(arch).reduced(n_layers=2, d_model=256, vocab=512)


CONFIGS = {"moe": lambda: tiny(MOE), "vlm": lambda: tiny(VLM),
           "deepseek": lambda: reduced("deepseek-moe-16b"),
           "arctic": lambda: reduced("arctic-480b"),
           "llava": lambda: reduced("llava-next-mistral-7b")}
TIER2 = pytest.mark.tier2


def cases(names, tier2):
    """``names`` as parameters, those in ``tier2`` under the tier2 mark."""
    return [pytest.param(n, marks=TIER2) if n in tier2 else n
            for n in sorted(names)]


# ---------------------------------------------------------------------------
# moe_forward


def _moe_inputs(cfg, T, seed):
    p = _np(jax_moe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (2, T // 2, cfg.d_model)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("shared", [1, 0])
@pytest.mark.parametrize("capacity", [None, 0.5])
@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_forward_matches_reference(dispatch, capacity, shared):
    """40 tokens; at factor 0.5 each expert keeps 16 of ~20 slots: the
    dropped (token, slot) pairs must be JAX's."""
    cfg = tiny(MOE, n_shared_experts=shared)
    p, x = _moe_inputs(cfg, 40, 3)
    jy, jaux = jax_moe.moe_forward(jax.tree.map(jnp.asarray, p), cfg,
                                   jnp.asarray(x), jax_blocks.DEFAULT_LIN,
                                   capacity_factor=capacity, dispatch=dispatch)
    pc = port_config(cfg)
    pp = jax.tree.map(_t, p)
    py, paux = port_moe.moe_forward(pp, pc, _t(x), port_blocks.DEFAULT_LIN,
                                    capacity_factor=capacity,
                                    dispatch=dispatch)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(paux), float(jaux), **TOL)
    other = "einsum" if dispatch == "scatter" else "scatter"
    oy, oaux = port_moe.moe_forward(pp, pc, _t(x), port_blocks.DEFAULT_LIN,
                                    capacity_factor=capacity, dispatch=other)
    np.testing.assert_allclose(oy.numpy(), py.numpy(), **TOL)
    assert float(oaux) == float(paux)
    if capacity is not None:        # the case does drop, and both agree
        cap = port_moe._capacity(40, cfg.n_experts, cfg.top_k, capacity)
        _, idx, _ = port_moe._route(pp, pc, _t(x),
                                    port_blocks.DEFAULT_LIN, "")
        assert not port_moe._slot_positions(idx, cfg.n_experts, cap)[1].all()
    _, none = port_moe.moe_forward(pp, pc, _t(x), port_blocks.DEFAULT_LIN,
                                   with_aux=False)
    assert none is None


def test_top_k_ties_pick_the_reference_experts():
    """A zero hidden state gives all-equal router logits and two equal
    router columns tie on every row: the port's stable sort picks the
    lower index first, as ``jax.lax.top_k``."""
    cfg = tiny(MOE)
    p, x = _moe_inputs(cfg, 12, 5)
    p["router"][:, 3] = p["router"][:, 1]
    xt = x.reshape(12, -1)
    xt[::3] = 0.0
    _, jidx, jaux = jax_moe._route(jax.tree.map(jnp.asarray, p), cfg,
                                   jnp.asarray(xt), jax_blocks.DEFAULT_LIN, "")
    _, pidx, paux = port_moe._route(jax.tree.map(_t, p), port_config(cfg),
                                    _t(xt)[None], port_blocks.DEFAULT_LIN, "")
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pidx[::3].numpy(), [[0, 1]] * 4)
    np.testing.assert_allclose(float(paux), float(jaux), **TOL)


def test_frozen_expert_grad_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 5, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16, 8)).astype(np.float32)
    g = rng.standard_normal((4, 5, 8)).astype(np.float32)
    jy, vjp = jax.vjp(jax_frozen_expert, jnp.asarray(x), jnp.asarray(w))
    jdx, _ = vjp(jnp.asarray(g))
    px, pw = _t(x).requires_grad_(), _t(w)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        py = frozen_expert(px, pw)
    (pdx,) = torch.autograd.grad(py, px, _t(g))
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(pdx.numpy(), np.asarray(jdx), **TOL)
    assert len(saved) == 1 and saved[0] is pw       # the weight, never x
    with torch.no_grad():                           # inference: inline
        assert torch.equal(frozen_expert(px, pw), torch.bmm(px, pw))


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode


def _image(cfg, B, seed=3):
    """JAX's ``frontend_stub`` draw, handed over as numpy."""
    return np.asarray(jax_frontend_stub(cfg, 1, B, seed=seed)["img_embed"][0])


@pytest.mark.parametrize("name", cases(CONFIGS, ("arctic", "deepseek",
                                                  "llava")))
def test_forward_matches_reference(name):
    cfg = CONFIGS[name]()
    np_base = numpy_params(cfg, 1)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jbatch, pbatch = {"tokens": jnp.asarray(tok)}, {"tokens": _t(tok)}
    if cfg.arch == VLM:
        img = _image(cfg, 2)
        jbatch["img_embed"], pbatch["img_embed"] = jnp.asarray(img), _t(img)
    jl, jaux = jax_get_model(cfg).forward(jax.tree.map(jnp.asarray, np_base),
                                          jbatch, remat=False)
    pc = port_config(cfg)
    pb = convert.params_from_numpy(pc, np_base, "cpu")
    pl, paux = get_model(pc).forward(pb, pbatch, remat=False, with_aux=True)
    assert pl.shape == jl.shape
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(float(paux), float(jaux), **TOL)
    if cfg.n_experts:
        assert float(paux) > 0
    kinds = ["moe" in layer for layer in pb["layers"]]
    assert kinds == [cfg.n_experts > 0 and i >= cfg.first_dense_layers
                     for i in range(cfg.n_layers)]
    assert all(("mlp" in layer) == (not k or cfg.dense_residual)
               for layer, k in zip(pb["layers"], kinds))


PREFILL_CASES = {   # (config, page_block, quant)
    "moe_paged": ("moe", 8, False),
    "moe_dense": ("moe", 0, False),
    "moe_paged_int8": ("moe", 8, True),
    "vlm_paged": ("vlm", 8, False),
    "vlm_dense": ("vlm", 0, False),
}


def _assert_caches(port_cache, jax_cache, cfg, quant):
    got = convert.caches_to_numpy(port_cache, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(jax_cache)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(jax_cache)):
        name = getattr(path[-1], "key", None)
        if quant and name in ("k", "v"):
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, **POOL_TOL, err_msg=str(path))


@pytest.mark.parametrize("case", cases(PREFILL_CASES, (
    "moe_dense", "moe_paged_int8", "vlm_paged")))
def test_prefill_then_decode_matches_reference(case):
    """Right-padded prompts of lengths 5 and 9 (a VLM's 8 image tokens
    before them), 3 greedy decode steps; logits and every cache leaf in
    JAX's layout."""
    name, blk, quant = PREFILL_CASES[case]
    cfg = CONFIGS[name]()
    np_base = numpy_params(cfg, 4)
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    lengths = np.array([5, 9], np.int32)
    kw = dict(page_block=blk, quant=quant)
    jm, pc = jax_get_model(cfg), port_config(cfg)
    pm = get_model(pc)
    jbase = jax.tree.map(jnp.asarray, np_base)
    pbase = convert.params_from_numpy(pc, np_base, "cpu")
    jcache = jm.init_cache(2, 32, **kw)
    pcache = pm.init_cache(2, 32, device="cpu", **kw)
    jbatch, pbatch = {"tokens": jnp.asarray(tok)}, {"tokens": _t(tok)}
    if cfg.arch == VLM:
        img = _image(cfg, 2)
        jbatch["img_embed"], pbatch["img_embed"] = jnp.asarray(img), _t(img)
    jl, jcache = jm.prefill(jbase, jbatch, jcache, lengths=jnp.asarray(lengths))
    pl, pcache = pm.prefill(pbase, pbatch, pcache, lengths=_t(lengths))
    tol = dict(atol=1e-3, rtol=1e-3) if quant else LOGIT_TOL
    for step in range(4):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **tol,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        _assert_caches(pcache, _np(jcache), cfg, quant)
        if step == 3:
            break
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jcache = jm.decode_step(jbase, jcache, jnp.asarray(nxt))
        pl, pcache = pm.decode_step(pbase, pcache, _t(nxt))
    if cfg.arch == VLM:      # image tokens first: decode resumed after them
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      cfg.n_frontend_tokens + lengths + 3)


# ---------------------------------------------------------------------------
# convert, configs, sizing, adapters, the frontend stub


def test_convert_round_trips_moe_trees():
    cfg = tiny(MOE)
    pc = port_config(cfg)
    np_base = numpy_params(cfg, 8)
    pb = convert.params_from_numpy(pc, np_base, "cpu")
    assert len(pb["layers"]) == cfg.n_layers and "pre_layers" not in pb
    back = convert.params_to_numpy(pb, pc)
    assert jax.tree.structure(back) == jax.tree.structure(np_base)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_base)):
        np.testing.assert_array_equal(a, b)
    acfg = AdapterConfig(method="lora", rank=4, targets=("q", "v", "router"))
    jbank = jax_bank(cfg, numpy_bank(cfg, acfg, 3, 2))
    want = jax.eval_shape(lambda: jax_adapters.init_client_bank(
        cfg, acfg, 3, jax.random.PRNGKey(2)))
    assert jax.tree.structure(jbank) == jax.tree.structure(want)
    pbank = convert.bank_from_numpy(port_acfg(acfg), jbank, "cpu")
    assert pbank["layers"]["router"]["A"].shape == (3, cfg.n_layers,
                                                    cfg.d_model, 4)
    for a, b in zip(jax.tree.leaves(convert.bank_to_numpy(pbank, pc)),
                    jax.tree.leaves(jbank)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    for kw in (dict(page_block=8), dict()):
        jc = _np(jax_sym.init_client_caches(cfg, 3, 2, 16, **kw))
        jc = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            a.dtype) if a.dtype == np.float32 else a, jc)
        pcache = convert.caches_from_numpy(jc, "cpu")
        assert pcache["layers"]["k"].shape[0] == cfg.n_layers
        want = port_sym.init_client_caches(pc, 3, 2, 16, device="cpu", **kw)
        assert pcache["layers"]["k"].shape == want["layers"]["k"].shape
        for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(pcache, pc)),
                        jax.tree.leaves(jc)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    want, got = jax_get_config(arch), get_config(arch)
    fields = pcfg.ModelConfig.__dataclass_fields__
    assert all(getattr(got, f) == getattr(want, f) for f in fields)
    r_want, r_got = want.reduced(), got.reduced()
    assert all(getattr(r_got, f) == getattr(r_want, f) for f in fields)
    assert got.ffn_hidden == want.ffn_hidden
    assert [got.is_moe_layer(i) for i in range(got.n_layers)] == \
        [want.is_moe_layer(i) for i in range(want.n_layers)]
    for quant in (False, True):
        assert port_kvcache.make_cache_spec(got, quant=quant) \
            .__dict__ == jax_kvcache.make_cache_spec(want, quant=quant).__dict__
        assert port_kvcache.cache_bytes(got, 300, 2, quant=quant,
                                        page_block=16) \
            == jax_kvcache.cache_bytes(want, 300, 2, quant=quant,
                                       page_block=16)


ADAPTERS = {"lora_router": AdapterConfig(method="lora", rank=8,
                                         targets=("q", "v", "router")),
            "lora_ffn": AdapterConfig(method="lora", rank=4,
                                      targets=("q", "gate", "down")),
            "ia3": AdapterConfig(method="ia3", targets=("k", "v", "down")),
            "prefix": AdapterConfig(method="prefix", n_prefix=4)}


@pytest.mark.parametrize("acfg", sorted(ADAPTERS))
def test_adapter_targets_and_bytes_match_reference(acfg):
    """The router target on MoE models only; ``adapter_bytes`` counts every
    layer's leaves (the router's on the dense first layer too), as JAX's
    per-layer tree does, on the tiny config and the full deepseek."""
    acfg = ADAPTERS[acfg]
    for cfg in (tiny(MOE), jax_get_config("deepseek-moe-16b"), tiny(VLM)):
        pc = port_config(cfg)
        assert port_adapters.resolve_targets(pc, port_acfg(acfg)) == \
            jax_adapters.resolve_targets(cfg, acfg)
        assert port_adapters.adapter_bytes(pc, port_acfg(acfg)) == \
            jax_adapters.adapter_bytes(cfg, acfg)
    tree = port_adapters.init_adapter(port_config(tiny(MOE)), port_acfg(acfg),
                                      torch.Generator(), device="cpu")
    n = sum(t.numel() for leaf in tree["layers"].values()
            for t in (leaf.values() if isinstance(leaf, dict) else [leaf]))
    assert n == jax_adapters.adapter_bytes(tiny(MOE), acfg)[0]


def test_frontend_stub():
    cfg = port_config(tiny(VLM))
    out = frontend_stub(cfg, 2, 3, generator=torch.Generator()
                        .manual_seed(1), device="cpu")["img_embed"]
    assert out.shape == (2, 3, cfg.n_frontend_tokens, cfg.d_model)
    assert out.dtype == torch.float32 and 0.015 < float(out.std()) < 0.025
    again = frontend_stub(cfg, 2, 3, generator=torch.Generator()
                          .manual_seed(1), device="cpu")["img_embed"]
    assert torch.equal(out, again)
    assert frontend_stub(port_config(tiny(MOE)), 2, 3,
                         generator=torch.Generator(), device="cpu") == {}
    want = jax_frontend_stub(tiny(VLM), 2, 3, seed=1)["img_embed"]
    assert tuple(want.shape) == tuple(out.shape)


def test_fine_tuning_refuses_moe_and_vlm():
    """Both families now fine-tune: the engine takes them and the train
    CLI trains reduced deepseek-moe-16b and llava-next-mistral-7b on the
    CPU (finite losses). The encoder-decoder family, once refused here,
    is taken too: the engine builds over it, the CLI trains whisper-small
    (reduced) and the model registry hands out ``models.encdec``. (The
    hybrid, RWKV and enc-dec fine-tune: ``test_torch_hybrid_train.py``,
    ``test_torch_rwkv_train.py``, ``test_torch_encdec_train.py``.)"""
    from repro_torch.launch import train
    for cfg in (tiny(MOE), tiny(VLM)):
        pc = port_config(cfg)
        base = get_model(pc).init_params(torch.Generator(), "cpu")
        FinetuneEngine(EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig()),
                       base, device="cpu")
    pe = port_config(tiny(ENCDEC))
    FinetuneEngine(EngineSpec(cfg=pe, finetune=pcfg.FinetuneConfig()),
                   get_model(pe).init_params(torch.Generator(), "cpu"),
                   device="cpu")
    for arch in ("deepseek-moe-16b", "llava-next-mistral-7b"):
        first, last = train.main(["--arch", arch, "--device", "cpu",
                                  "--steps", "2", "--clients", "2",
                                  "--seq", "8", "--d-model", "64"])
        assert np.isfinite(first) and np.isfinite(last)
    first, last = train.main(["--arch", "whisper-small", "--device", "cpu",
                              "--steps", "2", "--clients", "2", "--seq", "8",
                              "--d-model", "64"])
    assert np.isfinite(first) and np.isfinite(last)
    assert set(get_model(pe).init_params(torch.Generator(), "cpu")) >= \
        {"enc_layers", "dec_layers", "enc_pos", "dec_pos"}