"""PyTorch port vs the JAX reference: the hybrid (Jamba) family fine-tunes
on the shared base, on the CPU.

Checked on ``tiny(HYBRID)`` (4 layers in 2 periods of 2: a Mamba sublayer
with a dense MLP, then an attention sublayer with a 4-expert top-2 MoE),
fp32, base and adapters drawn by numpy in JAX's layout
(``test_torch_hybrid.numpy_params`` / ``numpy_bank``: one adapter leaf per
GROUP, the layout of both packages), batches from the synthetic pipeline
both packages draw alike. Against JAX at atol = rtol = 1e-5 (states after
optimizer steps as ``test_torch_train.assert_state_close`` holds them; the
hybrid's ``vmap`` drifts by 1-2 ulp, so no case compares bits across the
packages):

* the checkpointed ``selective_scan``'s grads (x, dt, B, C and the carried
  state) against ``jax.grad`` over three of the port's scan blocks;
* ``make_multi_client_train_step`` losses, gnorms, new bank and AdamW
  moments after one and three steps, LoRA (q, v and the router) and IA3,
  from one shared reference run; a prefix bank (which no sublayer of the
  hybrid reads) gets zero grads and moves by weight decay only;
* ``make_compact_train_step``'s per-row losses and states with a padding
  row and a NaN row (its slot keeps its bits in both packages);
* the group-shared router leaf's grad (one leaf per group, read by every
  MoE sublayer of the group) from ``make_row_grad_fn``;
* the ``FinetuneEngine``'s host state against JAX's for two hybrid jobs
  (LoRA, and IA3) behind a router that holds the second back: admissions, slots, step
  counts, stats, router charges (the port's by its own terms) and the
  kinds of the events, in order (JAX's ``compile`` events left out);
* the chunk contract: a training length over 256 that is no multiple of
  256 is refused by both, with JAX's words;
* the per-row aux loss of a ``rows=R`` forward against JAX's forward of
  each row (JAX ``vmap``s the rows); ``make_mixed_step`` (2 clients train,
  a dense bank decodes: logits, Mamba state and K/V, states); a job
  checkpoint written by either package restored by the other (JAX's
  ``groups`` tree, the same manifest).

Within the port: the checkpointed scan's values and grads equal the
unrecorded scan's bit for bit (so the serving paths, which record
nothing, are unchanged); the bytes autograd saves for one Mamba mixer and
for one recomputed scan block (``saved_tensors_hooks``) equal the charge's
new terms, a group adds what the charge adds, and the charge stays above
the saved tensors with and without ``remat``; a hybrid job killed and
resumed from ``engine_state`` equals its uninterrupted run bit for bit; a
``SymbiosisEngine`` serves every stream and trains every job as each
engine does alone.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import HYBRID
from repro.config import TrainConfig as JaxTrainConfig
from repro.core import symbiosis as jax_sym
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import mamba as jax_mamba
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import get_model
from repro_torch.models import mamba as port_mamba
from repro_torch.optim import AdamWState
from repro_torch.training import (FinetuneEngine, FinetuneJob,
                                  job_activation_bytes, make_job_stream)
from repro_torch.training import engine as port_engine
from conftest import tiny
from test_torch_finetune_engine import Pair
from test_torch_hybrid import _scan_inputs, numpy_bank, numpy_params
from test_torch_model import port_config
from test_torch_moe_train import _packed
from test_torch_train import assert_state_close

TOL = dict(atol=1e-5, rtol=1e-5)
ACFGS = {
    "lora": dict(method="lora", rank=4, alpha=8.0,
                 targets=("q", "v", "router")),
    "ia3": dict(method="ia3", targets=("k", "v", "down")),
    "prefix": dict(method="prefix", targets=("q", "v"), n_prefix=4),
}
B, S, R = 2, 12, 3
TRAIN = dict(lr=1e-2, warmup_steps=1, total_steps=4, max_grad_norm=1.0,
             weight_decay=0.1, remat=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def hybrid_system():
    cfg = tiny(HYBRID)
    return cfg, port_config(cfg), numpy_params(cfg, 21)


def batches(cfg, seed, n, lead):
    ds = JaxDataset(vocab=cfg.vocab, seq_len=S, n_clients=int(np.prod(lead)),
                    batch_per_client=B, seed=seed)
    return [{k: np.array(v).reshape(lead + v.shape[1:])
             for k, v in ds.batch(t).items()} for t in range(n)]


# ---------------------------------------------------------------------------
# the checkpointed scan


def _scan_grads(args, g, gh):
    """The port's scan and its grads for the loss sum(y*g) + sum(h*gh)."""
    ins = [_t(a).requires_grad_(i != 4) for i, a in enumerate(args)]
    with torch.enable_grad():
        y, h = port_mamba.selective_scan(*ins)
        grads = torch.autograd.grad((y * g).sum() + (h * gh).sum(),
                                    [ins[i] for i in (0, 1, 2, 3, 6)])
    return (y.detach(), h.detach()) + grads


def test_checkpointed_scan_grads_match_reference():
    """130 steps in one chunk: three of the port's checkpointed blocks;
    the grads of x, dt, B, C and the initial state against ``jax.grad``."""
    args = _scan_inputs(2, 130, 16, 8, seed=3)
    rng = np.random.default_rng(4)
    g = rng.standard_normal((2, 130, 16)).astype(np.float32)
    gh = rng.standard_normal((2, 16, 8)).astype(np.float32)

    def loss(x, dt, Bc, Cc, h0):
        y, h = jax_mamba.selective_scan(x, dt, Bc, Cc, jnp.asarray(args[4]),
                                        jnp.asarray(args[5]), h0)
        return jnp.sum(y * g) + jnp.sum(h * gh)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(args[i]) for i in (0, 1, 2, 3, 6)))
    got = _scan_grads(args, _t(g), _t(gh))[2:]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_checkpointed_scan_is_the_unrecorded_scan_bit_for_bit(monkeypatch):
    """Under autograd every block runs under ``torch.utils.checkpoint``;
    its values equal the scan with grad disabled (what every serving path
    runs) and its grads equal the un-checkpointed scan's, bit for bit."""
    args = _scan_inputs(2, 130, 16, 8, seed=5)
    g, gh = torch.randn(2, 130, 16), torch.randn(2, 16, 8)
    with torch.no_grad():
        y0, h0 = port_mamba.selective_scan(*map(_t, args))
    ckpt = _scan_grads(args, g, gh)
    assert torch.equal(ckpt[0], y0) and torch.equal(ckpt[1], h0)
    calls = []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: calls.append(1) or fn(*a))
    plain = _scan_grads(args, g, gh)
    assert len(calls) == 3
    for a, b in zip(ckpt, plain):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train makers against JAX's


@pytest.fixture(scope="module")
def multi_client_runs():
    """Three steps of ``make_multi_client_train_step`` per method in both
    packages: {method: [(port bank, opt, metrics), (JAX ...)] after steps
    1 and 3}."""
    cfg, pc, base = hybrid_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    jbase = jax.tree.map(jnp.asarray, base)
    out = {}
    for name in ("lora", "ia3", "prefix"):
        bank = numpy_bank(cfg, JaxAdapterConfig(**ACFGS[name]), R, 5)
        jfn = jax.jit(jax_sym.make_multi_client_train_step(
            cfg, JaxAdapterConfig(**ACFGS[name]), JaxTrainConfig(**TRAIN)))
        pfn = port_sym.make_multi_client_train_step(
            pc, pcfg.AdapterConfig(**ACFGS[name]), pcfg.TrainConfig(**TRAIN))
        jb = jax.tree.map(jnp.asarray, bank)
        jo = jax.vmap(jax_adamw_init)(jb)
        pbk = tree_map(_t, bank)
        po = AdamWState(step=torch.zeros(R, dtype=torch.int32),
                        m=tree_map(torch.zeros_like, pbk),
                        v=tree_map(torch.zeros_like, pbk))
        seen = []
        for t, b in enumerate(batches(cfg, 3, 3, (R,))):
            jb, jo, jm = jfn(jbase, jb, jo, jax.tree.map(jnp.asarray, b), t)
            pbk, po, pm = pfn(pb, pbk, po, tree_map(_t, b), t)
            if t in (0, 2):
                seen.append(((pbk, po, pm), (jb, jo, jm)))
        out[name] = (bank, seen)
    return out


@pytest.mark.parametrize("after", [1, 3])
@pytest.mark.parametrize("name", ["lora", "ia3"])
def test_multi_client_train_step_matches_reference(multi_client_runs, name,
                                                   after):
    """C = 3 clients on one schedule (group remat, drop-free experts at
    JAX's default capacity 1.25): losses, gnorms, bank and moments."""
    _, seen = multi_client_runs[name]
    (pbk, po, pm), (jb, jo, jm) = seen[0 if after == 1 else 1]
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), **TOL)
    np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), **TOL)
    assert_state_close(tuple(tree_map(np.asarray, t)
                             for t in (pbk, po.m, po.v)), (jb, jo.m, jo.v))
    np.testing.assert_array_equal(po.step.numpy(), np.asarray(jo.step))


def test_prefix_bank_does_nothing_on_the_hybrid(multi_client_runs):
    """No sublayer of the hybrid reads a prefix (JAX's behaviour, copied):
    the grads are zero, so the moments stay zero and each step moves the
    state by weight decay alone, in both packages; the losses agree."""
    bank, seen = multi_client_runs["prefix"]
    (pbk, po, pm), (jb, jo, jm) = seen[1]
    np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]),
                               **TOL)
    assert float(pm["gnorm"].abs().max()) == 0.0 == float(
        np.abs(np.asarray(jm["gnorm"])).max())
    for t in tree_leaves(po.m) + tree_leaves(po.v):
        assert not t.any()
    assert_state_close(tuple(tree_map(np.asarray, t)
                             for t in (pbk, po.m, po.v)), (jb, jo.m, jo.v))
    for a, b in zip(tree_leaves(pbk), tree_leaves(tree_map(_t, bank))):
        assert not torch.equal(a, b)          # weight decay moved it


CAP = 4
SLOTS = np.array([2, 0, 3], np.int32)
MASK = np.array([True, True, False])


def _hyper(t):
    return {"step": np.array([t, t + 2, 0], np.int32),
            "lr": np.array([1e-2, 3e-3, 0.0], np.float32),
            "warmup": np.array([1, 0, 0], np.float32),
            "total": np.array([6, 4, 1], np.float32),
            "wd": np.array([0.0, 0.1, 0.0], np.float32),
            "gnorm": np.array([1.0, np.inf, np.inf], np.float32)}


@pytest.mark.parametrize("name", ["lora", "ia3"])
def test_compact_train_step_matches_reference(name):
    """Two ticks of one bank: rows at slots 2 and 0 with their own
    schedules, slot 3 a padding row; at the second tick slot 0's adapter
    holds a NaN, so its row is not finite and commits nothing. Finite
    rows' losses and gnorms, every ``finite`` flag, and the bank and AdamW
    state after against JAX's ``vmap``ped step; the NaN row's and the
    untouched slots' state bit for bit as they were, in both."""
    cfg, pc, base = hybrid_system()
    jacfg = JaxAdapterConfig(**ACFGS[name])
    bank = numpy_bank(cfg, jacfg, CAP, 13)
    rng = np.random.default_rng(14)
    m = tree_map(lambda a: (rng.standard_normal(a.shape) * 0.01)
                 .astype(np.float32), bank)
    v = tree_map(lambda a: (rng.random(a.shape) * 1e-3).astype(np.float32),
                 bank)
    step = np.arange(CAP, dtype=np.int32) + 1
    jfn = jax.jit(jax_sym.make_compact_train_step(cfg, jacfg, remat=True))
    pfn = port_sym.make_compact_train_step(
        pc, pcfg.AdapterConfig(**ACFGS[name]), remat=True)
    jb = jax.tree.map(jnp.asarray, bank)
    jo = JaxAdamWState(step=jnp.asarray(step),
                       m=jax.tree.map(jnp.asarray, m),
                       v=jax.tree.map(jnp.asarray, v))
    pbk = tree_map(_t, bank)
    po = AdamWState(step=_t(step), m=tree_map(_t, m), v=tree_map(_t, v))
    jbase = jax.tree.map(jnp.asarray, base)
    pb = convert.params_from_numpy(pc, base, "cpu")
    for t, b in enumerate(batches(cfg, 15, 2, (R,))):
        if t == 1:                          # poison slot 0's adapter
            leaf = tree_leaves(pbk)[0]
            leaf[0].view(-1)[0] = float("nan")
            jb = jax.tree.map(lambda x: x, jb)
            first = jax.tree.leaves(jb)[0]
            jb = jax.tree.unflatten(
                jax.tree.structure(jb),
                [first.at[0].set(first[0].reshape(-1).at[0].set(jnp.nan)
                                 .reshape(first[0].shape))]
                + jax.tree.leaves(jb)[1:])
            before = [x.clone() for x in tree_leaves((pbk, po))]
            jbefore = [np.array(x) for x in jax.tree.leaves((jb, jo))]
        jb, jo, jm = jfn(jbase, jb, jo, jax.tree.map(jnp.asarray, b),
                         jnp.asarray(SLOTS), jnp.asarray(MASK),
                         jax.tree.map(jnp.asarray, _hyper(t)))
        pbk, po, pm = pfn(pb, pbk, po, tree_map(_t, b), _t(SLOTS), _t(MASK),
                          tree_map(_t, _hyper(t)))
        np.testing.assert_array_equal(pm["finite"].numpy(),
                                      np.asarray(jm["finite"]))
        ok = MASK & pm["finite"].numpy()
        assert ok.tolist() == ([True, True, False] if t == 0
                               else [True, False, False])
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(pm[k].numpy()[ok],
                                       np.asarray(jm[k])[ok], **TOL)
    for a, c in zip(tree_leaves((pbk, po)), before):
        for s_ in (0, 1, 3):             # NaN where it was: same bits
            np.testing.assert_array_equal(a[s_].numpy(), c[s_].numpy())
    for a, c in zip(jax.tree.leaves((jb, jo)), jbefore):
        for s_ in (0, 1, 3):
            np.testing.assert_array_equal(np.asarray(a[s_]), c[s_])
    rows = np.array([0, 2])
    assert_state_close(tuple(tree_map(lambda x: np.asarray(x[rows]), tr)
                             for tr in (pbk, po.m, po.v)),
                       tuple(jax.tree.map(lambda x: x[rows], tr)
                             for tr in (jb, jo.m, jo.v)))
    np.testing.assert_array_equal(po.step.numpy(), np.asarray(jo.step))


def test_group_shared_router_leaf_grad_matches_reference():
    """LoRA on the router alone: the group's one router leaf [G, ...] is
    read by every MoE sublayer of its group, and its grad is their sum, as
    ``jax.grad`` through JAX's group scan gives it."""
    cfg, pc, base = hybrid_system()
    ac = dict(method="lora", rank=4, alpha=8.0, targets=("router",))
    bank = numpy_bank(cfg, JaxAdapterConfig(**ac), 1, 17)
    b = batches(cfg, 18, 1, (1,))[0]
    jl, jg = jax.jit(jax_sym.make_row_grad_fn(
        cfg, JaxAdapterConfig(**ac), remat=True))(
        jax.tree.map(lambda a: jnp.asarray(a[0]), bank),
        jax.tree.map(jnp.asarray, base),
        {k: jnp.asarray(v[0]) for k, v in b.items()})
    pl, pg = port_sym.make_row_grad_fn(pc, pcfg.AdapterConfig(**ac))(
        tree_map(lambda a: _t(a[0]), bank),
        convert.params_from_numpy(pc, base, "cpu"),
        {k: _t(v[0]) for k, v in b.items()})
    np.testing.assert_allclose(float(pl), float(jl), **TOL)
    assert list(pg["groups"]) == ["router"]
    for a, c in zip(tree_leaves(pg), jax.tree.leaves(jg)):
        assert a.shape[0] == cfg.n_layers // cfg.attn_every
        assert float(a.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=2e-5,
                                   rtol=1e-4)


def test_chunk_contract_refuses_a_training_length():
    """A 260-token training sequence (over the 256-step chunk, no multiple
    of it) is refused by both packages' row programs, with JAX's words."""
    cfg, pc, base = hybrid_system()
    ac = ACFGS["lora"]
    bank = numpy_bank(cfg, JaxAdapterConfig(**ac), 1, 19)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 260)) \
        .astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(AssertionError, match="seq 260 % chunk 256 != 0"):
        jax_sym.make_row_grad_fn(cfg, JaxAdapterConfig(**ac))(
            jax.tree.map(lambda a: jnp.asarray(a[0]), bank),
            jax.tree.map(jnp.asarray, base),
            jax.tree.map(jnp.asarray, batch))
    with pytest.raises(ValueError, match="seq 260 % chunk 256 != 0"):
        port_sym.make_row_grad_fn(pc, pcfg.AdapterConfig(**ac))(
            tree_map(lambda a: _t(a[0]), bank),
            convert.params_from_numpy(pc, base, "cpu"),
            tree_map(_t, batch))


# ---------------------------------------------------------------------------
# the engines


class HybridPair(Pair):
    """``Pair`` over the hybrid base: adapters drawn in JAX's layout, which
    is the port's (``groups``)."""
    system = staticmethod(hybrid_system)

    def numpy_adapter(self, ja, seed):
        return tree_map(lambda a: a[0],
                        numpy_bank(self.cfg, ja, 1, 100 + seed))


@pytest.mark.parametrize("name", ["lora", "ia3"])
def test_finetune_engine_matches_reference(name):
    """Two jobs (LoRA on q, v, router; IA3 on k, v, down) behind a router
    with room for one, tick by tick against the JAX engine: admissions,
    slots, steps, stats, the router ledgers (the port's by its own terms),
    losses and final states; both engines' events, kind by kind in
    order."""
    from repro.obs import Obs as JaxObs
    from repro_torch.obs import Obs
    from repro_torch.training import job_charge_bytes, job_hbm_bytes
    probe = HybridPair()
    _, pj = probe.make(0, steps=2, seq=S, acfg=ACFGS[name])
    p = HybridPair(slot_bytes=job_hbm_bytes(probe.pc, pj) * 1.5,
                   port_slot_bytes=job_charge_bytes(probe.pc, pj) * 1.5)
    for eng, obs in ((p.jax, JaxObs()), (p.port, Obs())):
        eng._obs, eng._span = obs, obs.span
        obs.attach("finetune", eng)
    p.submit(0, steps=2, seq=S, acfg=ACFGS[name])
    p.submit(1, steps=2, seq=S, acfg=ACFGS[name])        # waits for a slot
    p.tick()
    assert p.port.n_active == 1 and len(p.port._queue) == 1
    p.run()
    assert p.port.stats["train_steps"] == 4
    # JAX's ``compile`` events have no counterpart (a stated departure)
    kinds = [[e.kind for e in eng.drain_events() if e.kind != "compile"]
             for eng in (p.jax, p.port)]
    assert kinds[0] == kinds[1]
    assert kinds[1].count("admit") == 2 == kinds[1].count("retire")


def test_symbiosis_engine_serves_beside_hybrid_jobs():
    """LoRA tenants (q, v, router) served on pages beside two hybrid jobs
    on ONE base: every stream equals serving alone and every job its
    ``FinetuneEngine`` run alone, bit for bit."""
    from repro_torch.core.engine_spec import BankSpec
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.training import SymbiosisEngine
    cfg, pc, base = hybrid_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    pacfg = pcfg.AdapterConfig(**ACFGS["lora"])
    bank = convert.bank_from_numpy(pacfg, numpy_bank(
        cfg, JaxAdapterConfig(**ACFGS["lora"]), 2, 31), "cpu")
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, 2),),
                      serve=pcfg.ServeConfig(n_clients=2, max_seq=32,
                                             page_block=8),
                      finetune=pcfg.FinetuneConfig(),
                      max_batch_per_client=2)

    def requests():
        rng = np.random.default_rng(5)
        return [Request(client_id=i % 2, max_new_tokens=5, arrive_tick=i,
                        prompt=rng.integers(0, pc.vocab, (1, 6))
                        .astype(np.int32)) for i in range(3)]

    sym = SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                    device="cpu")
    reqs, jobs = requests(), _engine_jobs(pc, 2)
    for item in reqs + jobs:
        sym.submit(item)
    done_r, done_j = sym.run()
    assert len(done_r) == 3 and len(done_j) == 2
    serv = ServingEngine(spec, pb, [bank], device="cpu")
    alone = requests()
    for r in alone:
        serv.submit(r)
    serv.run()
    for a, b in zip(reqs, alone):
        np.testing.assert_array_equal(a.generated, b.generated)
    ft = FinetuneEngine(spec, pb, device="cpu")
    solo = _engine_jobs(pc, 2)
    for j in solo:
        ft.submit(j)
    ft.run()
    for a, b in zip(jobs, solo):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)


def _engine_jobs(pc, n_steps=3):
    return [FinetuneJob(acfg=pcfg.AdapterConfig(**ACFGS[m]), batch_size=2,
                        seq_len=S, steps=n_steps, seed=i, lr=1e-2,
                        warmup_steps=1, name=f"{m}-{i}",
                        data=make_job_stream(pc, 2, S, seed=i, device="cpu"))
            for i, m in enumerate(("lora", "lora"))]


def test_killed_job_resumes_bit_for_bit():
    """Two jobs of one bank: killed after 1 of 3 ticks, the snapshot
    pickled and loaded into a fresh engine over the same base, both jobs
    continue their uninterrupted trajectories bit for bit (losses, final
    adapters and moments, stats); the adapter tree keeps JAX's
    ``groups`` layout."""
    _, pc, base = hybrid_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    spec = EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig())
    ref = FinetuneEngine(spec, pb, device="cpu")
    jobs = _engine_jobs(pc)
    for j in jobs:
        ref.submit(j)
    ref.run()
    first = FinetuneEngine(spec, pb, device="cpu")
    for j in _engine_jobs(pc):
        first.submit(j)
    first.train_tick()
    state = pickle.loads(pickle.dumps(first.engine_state()))
    assert set(state["active"][0]["init_adapter"]) == {"groups"}
    resumed = FinetuneEngine(spec, pb, device="cpu")
    resumed.load_engine_state(state)
    done = resumed.run()
    assert [j.name for j in done] == [j.name for j in jobs]
    for a, b in zip(done, jobs):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)
    assert resumed.stats == ref.stats


# ---------------------------------------------------------------------------
# the charge's Mamba terms against the tensors autograd saves


def act_config(dtype, **kw):
    base = dict(name="t", arch="hybrid", n_layers=4, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=96, vocab=200, head_dim=16, dtype=dtype,
                param_dtype=dtype, attn_every=2, n_experts=4, top_k=2,
                moe_every=2, moe_offset=1, d_state=8, d_conv=4)
    base.update(kw)
    return pcfg.ModelConfig(**base)


def _stored(seen, skip):
    return sum(t.untyped_storage().nbytes() for p, t in seen.items()
               if p not in skip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mem_opt", [True, False])
@pytest.mark.parametrize("S_", [24, 130])
def test_mamba_terms_count_the_saved_tensors(dtype, mem_opt, S_):
    """One Mamba mixer whose input requires grad saves exactly
    ``_mamba_saved_bytes`` (``S_`` 130: three checkpointed blocks, three
    carried states), and one recomputed scan block exactly
    ``_scan_block_saved_bytes``; the base's own leaves, resident, are
    left out."""
    cfg = act_config(dtype)
    g = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_params(g, "cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not mem_opt), base)
    lin = make_client_ctx(cfg, pcfg.AdapterConfig(**ACFGS["lora"]),
                          memory_optimized=mem_opt).for_layer(None)
    x = torch.randn((2, S_, cfg.d_model), generator=g) \
        .to(getattr(torch, dtype)).requires_grad_(True)
    skip = {t.untyped_storage().data_ptr() for t in tree_leaves(base) + [x]}
    p = base["groups"][0]["sub0"]["mamba"]
    with torch.enable_grad():
        _, seen = _packed(lambda: port_mamba.mamba_forward(p, cfg, x, lin,
                                                           None))
    assert _stored(seen, skip) == port_engine._mamba_saved_bytes(
        cfg, 2, S_, mem_opt)
    ed, c = cfg.mamba_expand * cfg.d_model, min(S_, port_mamba.SCAN_BLOCK)
    ins = [torch.randn(2, ed, 8), torch.randn(2, c, ed), torch.rand(2, c, ed),
           torch.randn(2, c, 8), torch.randn(2, c, 8), -torch.rand(ed, 8)]
    for t in ins[:5]:
        t.requires_grad_(True)
    with torch.enable_grad():
        _, blk = _packed(lambda: port_mamba._scan_block_saved(*ins))
    assert _stored(blk, {t.untyped_storage().data_ptr() for t in ins}) == \
        port_engine._scan_block_saved_bytes(cfg, 2, S_)


def _step_saved_bytes(cfg, acfg, mem_opt, remat):
    """Bytes of the storages autograd packs for one job's step (2 x 24
    tokens), the base and adapter leaves left out."""
    from repro_torch.core import adapters as port_adapters
    from repro_torch.models.losses import lm_loss
    g = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_params(g, "cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not mem_opt), base)
    params = tree_map(lambda x: x.detach().requires_grad_(True),
                      port_adapters.init_adapter(cfg, acfg, g, device="cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    skip = {t.untyped_storage().data_ptr()
            for t in tree_leaves(base) + tree_leaves(params)}
    ctx = make_client_ctx(cfg, acfg, memory_optimized=mem_opt)
    with torch.enable_grad():
        (logits, aux), seen = _packed(lambda: get_model(cfg).forward(
            base, {"tokens": toks}, ctx, params, remat=remat, with_aux=True))
        _, more = _packed(lambda: lm_loss(logits, toks, None, aux))
    seen.update(more)
    return _stored(seen, skip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method,mem_opt", [("lora", True), ("ia3", True),
                                            ("lora_up", False)])
def test_activation_term_counts_hybrid_groups(dtype, method, mem_opt):
    """A third group (2 -> 3 periods: a Mamba sublayer with a dense MLP and
    an attention sublayer with an MoE, every input requiring grad behind
    the first group's adapters) adds to the step's saved tensors exactly
    what ``job_activation_bytes`` adds per group; the charge stays above
    the step's saved tensors, with and without ``remat``."""
    acfg = {"lora": pcfg.AdapterConfig(**ACFGS["lora"]),
            "ia3": pcfg.AdapterConfig(**ACFGS["ia3"]),
            "lora_up": pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0,
                                          targets=("q", "v", "up",
                                                   "router"))}[method]
    job = FinetuneJob(acfg=acfg, data=None, batch_size=2, seq_len=24,
                      steps=1)
    cfgs = {L: act_config(dtype, n_layers=L) for L in (4, 6)}
    got = {L: _step_saved_bytes(c, acfg, mem_opt, False)
           for L, c in cfgs.items()}
    want = {L: job_activation_bytes(c, job, memory_optimized=mem_opt)
            for L, c in cfgs.items()}
    assert got[6] - got[4] == want[6] - want[4]
    for remat in (False, True):
        for L, c in cfgs.items():
            assert job_activation_bytes(c, job, remat=remat,
                                        memory_optimized=mem_opt) >= \
                _step_saved_bytes(c, acfg, mem_opt, remat)


def test_rows_aux_matches_reference():
    """The forward over R = 3 bank rows (``rows=3``): each row's MoE
    sublayers route its own tokens, and its summed aux loss equals JAX's
    forward of that row alone (JAX ``vmap``s the rows), with its own
    adapter through the group's shared leaf."""
    from repro.core.virtlayer import make_client_ctx as jax_client_ctx
    from repro.models import get_model as jax_get_model
    from repro_torch.core import adapters as port_adapters
    from repro_torch.core.virtlayer import make_bank_ctx
    cfg, pc, base = hybrid_system()
    ac = ACFGS["lora"]
    bank = numpy_bank(cfg, JaxAdapterConfig(**ac), R, 23)
    toks = batches(cfg, 24, 1, (R,))[0]["tokens"]               # [R, B, S]
    jctx = jax_client_ctx(cfg, JaxAdapterConfig(**ac))
    jbase = jax.tree.map(jnp.asarray, base)
    want = jax.vmap(lambda ad, t: jax_get_model(cfg).forward(
        jbase, {"tokens": t}, jctx, ad)[1])(
        jax.tree.map(jnp.asarray, bank), jnp.asarray(toks))
    pacfg = pcfg.AdapterConfig(**ac)
    with torch.no_grad():
        _, aux = get_model(pc).forward(
            convert.params_from_numpy(pc, base, "cpu"),
            {"tokens": _t(toks).flatten(0, 1)}, make_bank_ctx(pc, pacfg, R),
            port_adapters.compact_adapter_bank(tree_map(_t, bank),
                                               per_row=B),
            with_aux=True, rows=R)
    assert aux.shape == (R,)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want), **TOL)


def test_mixed_step_matches_reference():
    """JAX's ``make_mixed_step`` on the hybrid (2 clients train, then every
    slot of a dense 2-client bank decodes one token) against the port's:
    metrics, logits, the Mamba state and K/V caches, and the states."""
    from repro.config import ServeConfig as JaxServeConfig
    from test_torch_model import LOGIT_TOL, POOL_TOL
    cfg, pc, base = hybrid_system()
    ac = ACFGS["lora"]
    ja, pa = JaxAdapterConfig(**ac), pcfg.AdapterConfig(**ac)
    tkw = dict(lr=1e-2, warmup_steps=1, remat=False)
    ft = numpy_bank(cfg, ja, 2, 25)
    inf = numpy_bank(cfg, ja, 2, 26)
    b = batches(cfg, 27, 1, (2,))[0]
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 2)) \
        .astype(np.int32)
    jfb = jax.tree.map(jnp.asarray, ft)
    out = jax.jit(jax_sym.make_mixed_step(
        cfg, ja, JaxTrainConfig(n_clients=2, **tkw),
        JaxServeConfig(n_clients=2, max_seq=16)))(
        jax.tree.map(jnp.asarray, base), jfb, jax.vmap(jax_adamw_init)(jfb),
        jax.tree.map(jnp.asarray, b), jax.tree.map(jnp.asarray, inf),
        jax_sym.init_client_caches(cfg, 2, 2, 16), jnp.asarray(toks), 1)
    fb = tree_map(_t, ft)
    fo = AdamWState(step=torch.zeros(2, dtype=torch.int32),
                    m=tree_map(torch.zeros_like, fb),
                    v=tree_map(torch.zeros_like, fb))
    got = port_sym.make_mixed_step(
        pc, pa, pcfg.TrainConfig(**tkw),
        pcfg.ServeConfig(n_clients=2, max_seq=16))(
        convert.params_from_numpy(pc, base, "cpu"), fb, fo, tree_map(_t, b),
        tree_map(_t, inf), port_sym.init_client_caches(pc, 2, 2, 16,
                                                       device="cpu"),
        _t(toks), 1)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(out[3]),
                               **LOGIT_TOL)
    for k in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(got[4][k].numpy(), np.asarray(out[4][k]),
                                   **TOL)
    assert_state_close(tuple(tree_map(np.asarray, t)
                             for t in (got[0], got[1].m, got[1].v)),
                       (out[0], out[1].m, out[1].v))
    pcache = convert.caches_to_numpy(got[2], pc)
    jcache = jax.tree.map(np.asarray, out[2])
    np.testing.assert_array_equal(pcache["pos"], jcache["pos"])
    for a, c in zip(jax.tree.leaves(pcache["groups"]),
                    jax.tree.leaves(jcache["groups"])):
        np.testing.assert_allclose(a, c, **POOL_TOL)


def test_job_checkpoint_crosses_both_ways():
    """A hybrid job's adapter (one leaf per group) and AdamW state written
    by either package restore in the other: JAX's ``groups`` tree, key
    names and leaf shapes, the same manifest."""
    import json
    import os
    import tempfile
    from repro.checkpoint import ckpt as jax_ckpt
    from repro_torch.checkpoint import restore_job_state, save_job_state
    from repro_torch.optim import adamw_init
    cfg, pc, _ = hybrid_system()
    bank = numpy_bank(cfg, JaxAdapterConfig(**ACFGS["lora"]), 1, 40)
    mom = tree_map(lambda a: np.random.default_rng(41).standard_normal(
        a.shape).astype(np.float32), bank)
    pad = tree_map(lambda a: _t(a[0]), bank)
    popt = AdamWState(step=torch.tensor(5, dtype=torch.int32),
                      m=tree_map(lambda a: _t(a[0]), mom),
                      v=tree_map(lambda a: _t(np.abs(a[0])), mom))
    jad = jax.tree.map(lambda a: jnp.asarray(a[0]), bank)
    jopt = JaxAdamWState(step=jnp.asarray(5, jnp.int32),
                         m=jax.tree.map(lambda a: jnp.asarray(a[0]), mom),
                         v=jax.tree.map(lambda a: jnp.abs(jnp.asarray(a[0])),
                                        mom))
    with tempfile.TemporaryDirectory() as d:
        jpath = jax_ckpt.save_job_state(os.path.join(d, "j"), 5, jad, jopt,
                                        name="t")
        ppath = save_job_state(os.path.join(d, "p"), 5, pad, popt, name="t",
                               cfg=pc)
        with open(os.path.join(jpath, "manifest.json")) as f:
            jm = json.load(f)
        with open(os.path.join(ppath, "manifest.json")) as f:
            assert json.load(f) == jm
        assert any(k.startswith("adapter/groups/") for k in
                   json.dumps(jm).replace('"', " ").split())
        like = tree_map(torch.zeros_like, pad)
        got_ad, got_opt = restore_job_state(os.path.join(d, "j"), 5, like,
                                            adamw_init(like), name="t",
                                            device="cpu", cfg=pc)
        for a, b in zip(tree_leaves((got_ad, got_opt)),
                        tree_leaves((pad, popt))):
            assert torch.equal(a, b)
        jgot_ad, jgot_opt = jax_ckpt.restore_job_state(
            os.path.join(d, "p"), 5, jad, jopt, name="t")
        for a, b in zip(jax.tree.leaves((jgot_ad, jgot_opt)),
                        jax.tree.leaves((jad, jopt))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
