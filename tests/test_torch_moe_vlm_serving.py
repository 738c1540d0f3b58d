"""PyTorch port vs the JAX reference: the MoE and VLM families behind the
serving engine, on the CPU.

On ``tiny(MOE)`` (3 layers, the first dense, 4 experts top-2, 1 shared)
and ``tiny(VLM)`` fp32, weights and banks drawn by numpy from seeds
(``test_torch_moe``) and handed to both packages, JAX's banks with its
``pre_layers`` split off:

* the port's engine against the JAX engine tick by tick, both
  ``debug=True``: host state (admissions, slots, pages, tables, refcounts
  and the prefix index on pages), router charges, ``stats`` and the
  conservation audit equal after every tick, greedy streams identical —
  LoRA on q and v and on q, v and the router, IA3 and prefix banks, on
  both KV layouts (int8 pages too), a VLM served as its text backbone;
* the one stated departure: a LoRA adapter on the router is applied in the
  compacted prefill per ROW (each row's S tokens take its client's
  adapter), where JAX's ``apply_adapter_rows`` gives the flattened [n*S,
  d] router input one block per TOKEN, so its compacted prefill hands the
  first n tokens the n rows' routers and the rest none. The port's
  compacted prefill equals JAX's per-client prefill (``ragged_prefill=
  False`` on pages, the dense layout's path) on those runs, and its host
  state equals JAX's default engine;
* the compacted decode step equals the masked bank-wide step over every
  slot, bit for bit, port against port.

Tier-1 runs LoRA (q, v, router) on the dense layout and, through the
departure, on pages, and the serving CLI on deepseek-moe-16b reduced. The
other methods and paths, the VLM engine and the llava CLI run under
``-m tier2``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, MOE, VLM, ServeConfig
from repro.core import adapters as jax_adapters
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.serving.engine import Request, ServingEngine
from conftest import tiny
from test_torch_dense_serving import dense_work, engine_state, serve_both
from test_torch_mixed_serving import (host_state, port_acfg, port_scfg,
                                      serve_lockstep)
from test_torch_model import port_config
from test_torch_moe import TIER2, jax_bank, numpy_bank, numpy_params

C, MAX_SEQ, BLK = 3, 32, 8
LORA = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
ROUTER = AdapterConfig(method="lora", rank=4, alpha=8.0,
                       targets=("q", "v", "router"))
IA3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))
PREFIX = AdapterConfig(method="prefix", targets=("q", "v"), n_prefix=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def make_engines(cfg, acfg, scfg, *, jax_kw=None, **kw):
    """The JAX and the port engine over the same numpy base and one bank
    of C clients, both ``debug=True``; ``kw`` goes to both, ``jax_kw`` to
    the JAX engine only."""
    np_base = numpy_params(cfg, 11)
    np_bank = numpy_bank(cfg, acfg, C, 12)
    jspec = JaxEngineSpec(cfg=cfg, banks=(JaxBankSpec("b", acfg, C),),
                          serve=scfg, max_batch_per_client=2)
    jeng = JaxServingEngine(jspec, jax.tree.map(jnp.asarray, np_base),
                            [jax.tree.map(jnp.asarray, jax_bank(cfg, np_bank))],
                            debug=True, **kw, **(jax_kw or {}))
    pc = port_config(cfg)
    pspec = EngineSpec(cfg=pc, banks=(BankSpec("b", port_acfg(acfg), C),),
                       serve=port_scfg(scfg), max_batch_per_client=2)
    peng = ServingEngine(pspec, convert.params_from_numpy(pc, np_base, "cpu"),
                         [convert.bank_from_numpy(port_acfg(acfg), np_bank,
                                                  "cpu")],
                         device="cpu", debug=True, **kw)
    return jeng, peng


ENGINE_CASES = {   # (family, adapter, ServeConfig changes, engine kwargs)
    "moe_paged_router": (MOE, ROUTER, dict(page_block=BLK),
                         dict(ragged_prefill=False)),
    "moe_dense_router": (MOE, ROUTER, dict(), dict()),
    "vlm_paged_lora": (VLM, LORA, dict(page_block=BLK), dict()),
    "moe_paged_lora": (MOE, LORA, dict(page_block=BLK), dict()),
    "moe_paged_ia3": (MOE, IA3, dict(page_block=BLK), dict()),
    "moe_paged_prefix": (MOE, PREFIX, dict(page_block=BLK), dict()),
    "moe_paged_int8": (MOE, ROUTER, dict(page_block=BLK, kv_quant=True),
                       dict(ragged_prefill=False)),
    "moe_dense_ia3": (MOE, IA3, dict(), dict()),
    "moe_dense_prefix": (MOE, PREFIX, dict(), dict()),
    "vlm_dense_lora": (VLM, LORA, dict(), dict()),
}
TIER1 = ("moe_dense_router",)


@pytest.mark.parametrize("case", [
    c if c in TIER1 else pytest.param(c, marks=TIER2)
    for c in sorted(ENGINE_CASES)])
def test_engine_matches_reference_tick_by_tick(case):
    """The compacted path at its defaults (shared-prefix pages on) is held
    to JAX's host state, prefix index and refcounts included
    (``serve_lockstep``); the per-request and dense paths to
    ``engine_state`` (``serve_both``)."""
    arch, acfg, skw, ekw = ENGINE_CASES[case]
    cfg = tiny(arch)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, **skw)
    jeng, peng = make_engines(cfg, acfg, scfg, **ekw)
    work = dense_work(cfg.vocab)
    if peng._paged and not ekw:
        assert peng._compact_prefill
        serve_lockstep(jeng, peng, work)
    else:
        serve_both(jeng, peng, work)
    if cfg.arch == MOE and not peng._paged:
        assert peng.stats["ragged_prefill_batches"] > 0


def test_router_lora_on_the_compacted_prefill():
    """The stated departure. Per-row application of the router: the
    port's, on the [n, S, d] rows ``moe._route`` hands it, equals each
    row's own adapter; JAX's, on the same tokens flattened as its router
    hands them, does not (it gives blocks per token); and the port's
    compacted-prefill engine serves the streams of JAX's per-client-prefill
    engine, with the host state of JAX's compacted-prefill engine tick by
    tick."""
    cfg = tiny(MOE)
    pc, pacfg = port_config(cfg), port_acfg(ROUTER)
    rng = np.random.default_rng(3)
    n, S, d = 3, 4, cfg.d_model
    bank = numpy_bank(cfg, ROUTER, C, 5)
    leaf = {"router": jax.tree.map(lambda a: a[:, 1],
                                   bank["layers"]["router"])}   # [C, ...]
    x = rng.standard_normal((n * S, d)).astype(np.float32)
    y = rng.standard_normal((n * S, cfg.n_experts)).astype(np.float32)
    rows = np.array([2, 0, 1], np.int32)
    got = port_adapters.apply_adapter_rows(
        _t(y).reshape(n, S, -1), _t(x).reshape(n, S, d), "router",
        jax.tree.map(_t, leaf), pacfg, pc, _t(rows)).reshape(n * S, -1)
    want = np.concatenate([np.asarray(jax_adapters.apply_adapter(
        jnp.asarray(y[i * S:(i + 1) * S]), jnp.asarray(x[i * S:(i + 1) * S]),
        "router", jax.tree.map(lambda a: jnp.asarray(a[c]), leaf), ROUTER,
        cfg)) for i, c in enumerate(rows)])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    jrows = np.asarray(jax_adapters.apply_adapter_rows(
        jnp.asarray(y), jnp.asarray(x), "router",
        jax.tree.map(jnp.asarray, leaf), ROUTER, cfg, jnp.asarray(rows)))
    for i, c in enumerate(rows):     # JAX: token i takes row i's router
        np.testing.assert_allclose(jrows[i], np.asarray(
            jax_adapters.apply_adapter(
                jnp.asarray(y[i]), jnp.asarray(x[i]), "router",
                jax.tree.map(lambda a, c=c: jnp.asarray(a[c]), leaf),
                ROUTER, cfg)), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(jrows[n:], y[n:])   # and the rest none
    assert not np.allclose(jrows, want, atol=1e-3)

    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    work = dense_work(cfg.vocab)
    jeng, peng = make_engines(cfg, ROUTER, scfg)
    jreqs = [JaxRequest(**w) for w in work]
    preqs = [Request(**w) for w in work]
    jidx = {id(r): i for i, r in enumerate(jreqs)}
    pidx = {id(r): i for i, r in enumerate(preqs)}
    for jr, pr in zip(jreqs, preqs):
        jeng.submit(jr)
        peng.submit(pr)
    more, ticks = True, 0
    while more:
        more = jeng.service_tick()
        assert peng.service_tick() == more
        assert host_state(peng, pidx) == host_state(jeng, jidx), ticks
        ticks += 1
    per_client, _ = make_engines(cfg, ROUTER, scfg, ragged_prefill=False)
    ref = [JaxRequest(**w) for w in work]
    for r in ref:
        per_client.submit(r)
    per_client.run()
    for i, (pr, jr, rr) in enumerate(zip(preqs, jreqs, ref)):
        np.testing.assert_array_equal(pr.generated, rr.generated,
                                      err_msg=f"request {i}")
    assert any(not np.array_equal(jr.generated, rr.generated)
               for jr, rr in zip(jreqs, ref))   # JAX's compacted prefill


@pytest.mark.parametrize("arch", [MOE, VLM])
def test_compact_decode_equals_masked_decode_bitwise(arch):
    """Every slot active: the masked step over the bank and the compacted
    step over all C*B rows in (client, slot) order, on copies of the same
    caches, give the same logits and pools bit for bit (router LoRA on
    the MoE)."""
    cfg = tiny(arch)
    acfg = ROUTER if arch == MOE else LORA
    pc, pacfg = port_config(cfg), port_acfg(acfg)
    scfg = port_scfg(ServeConfig(n_clients=C, max_seq=MAX_SEQ,
                                 page_block=BLK))
    pbase = convert.params_from_numpy(pc, numpy_params(cfg, 11), "cpu")
    pbank = convert.bank_from_numpy(pacfg, numpy_bank(cfg, acfg, C, 12),
                                    "cpu")
    nb = MAX_SEQ // BLK
    P = 2 * nb
    pcache = port_sym.init_client_caches(pc, C, 2, MAX_SEQ, page_block=BLK,
                                         pool_pages=P, device="cpu")
    pcache["block_tbl"] = _t((np.arange(C)[:, None, None] * P
                              + np.arange(P).reshape(2, nb)[None])
                             .astype(np.int32))
    rng = np.random.default_rng(10)
    prefill = port_sym.make_client_prefill(pc, pacfg, scfg)
    for c in range(C):
        toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
        prefill(pbase, pbank, pcache, c, c, _t(toks),
                _t(np.array([8, 3], np.int32)), torch.ones(2, dtype=torch.bool))
    other = jax.tree.map(torch.clone, pcache)
    masked = port_sym.make_masked_decode_step(pc, pacfg, scfg)
    compact = port_sym.make_compact_decode_step(pc, pacfg, scfg)
    clients = torch.arange(C, dtype=torch.int32).repeat_interleave(2)
    slots = torch.arange(2, dtype=torch.int32).repeat(C)
    for _ in range(3):
        tok = _t(rng.integers(0, cfg.vocab, (C, 2)).astype(np.int32))
        lm, pcache = masked(pbase, pbank, pcache, tok,
                            torch.ones((C, 2), dtype=torch.bool))
        lc, _, other = compact(pbase, pbank, other, tok.reshape(-1), clients,
                               slots, torch.ones(C * 2, dtype=torch.bool))
        assert torch.equal(lm.reshape(C * 2, -1), lc)
    for a, b in zip(jax.tree.leaves(pcache), jax.tree.leaves(other)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [
    "deepseek-moe-16b",
    pytest.param("llava-next-mistral-7b", marks=TIER2)])
def test_serve_cli_serves_moe_and_vlm(arch, capsys):
    """The serving CLI takes both families' configs (reduced on the CPU):
    its header, results and simulated-timeline lines."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", arch, "--device", "cpu", "--clients", "2",
                       "--requests", "2", "--prompt-len", "8", "--max-new",
                       "3", "--page-block", "8"])
    assert len(done) == 2 and all(r.status == "ok" for r in done)
    assert capsys.readouterr().out.count("[serve]") == 3
