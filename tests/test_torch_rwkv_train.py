"""PyTorch port vs the JAX reference: the RWKV6 family fine-tunes on the
shared base, on the CPU.

Checked on ``tiny(RWKV)`` fp32, base and adapters drawn by numpy in JAX's
layout (``test_torch_rwkv.numpy_params`` / ``numpy_bank``), batches from
the synthetic pipeline both packages draw alike. Against JAX at atol =
rtol = 1e-5 (states after optimizer steps as
``test_torch_train.assert_state_close`` holds them; RWKV's ``vmap`` drifts
by 1-2 ulp, so no case compares bits across the packages):

* ``make_multi_client_train_step`` losses, gnorms, new bank and AdamW
  moments after one and three steps, LoRA (q as r, v, cm_k) and IA3 (k,
  v), from one shared reference run;
* ``make_compact_train_step``'s per-row losses and states with a padding
  row and, at the second tick, a NaN row (its slot keeps its bits in both
  packages);
* the ``FinetuneEngine``'s host state against JAX's for two LoRA jobs
  behind a router that holds the second back: admissions, slots, step
  counts, stats, router charges (the port's by its own terms) and the
  kinds of the events, in order (JAX's ``compile`` events left out);
* the chunk contract: a 130-token training sequence is refused by both,
  with JAX's words.

Within the port: a prefix bank (which no layer reads) trains on the bare
base's losses with zero grads, its state moved by weight decay alone; the
bytes autograd saves for one RWKV layer (a third
layer's difference, ``saved_tensors_hooks``) and for one recomputed wkv
block equal the charge's new terms, in fp32 and bf16, with and without
§3.6, and the charge stays above the step's saved tensors with and
without ``remat``; a job killed after one of three ticks and resumed from
``engine_state`` equals its uninterrupted run bit for bit; a
``SymbiosisEngine`` serves every stream and trains every job as each
engine does alone; the train CLI trains rwkv6-7b reduced.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import RWKV
from repro.config import TrainConfig as JaxTrainConfig
from repro.core import symbiosis as jax_sym
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import get_model
from repro_torch.models import rwkv as port_rwkv
from repro_torch.models.losses import lm_loss
from repro_torch.optim import AdamWState
from repro_torch.training import (FinetuneEngine, FinetuneJob,
                                  job_activation_bytes, make_job_stream)
from repro_torch.training import engine as port_engine
from conftest import tiny
from test_torch_finetune_engine import Pair
from test_torch_hybrid_train import _hyper, batches
from test_torch_model import port_config
from test_torch_moe_train import _packed
from test_torch_rwkv import numpy_bank, numpy_params
from test_torch_rwkv import one_thread  # noqa: F401 (autouse fixture)
from test_torch_train import assert_state_close

TOL = dict(atol=1e-5, rtol=1e-5)
ACFGS = {
    "lora": dict(method="lora", rank=4, alpha=8.0, targets=("q", "v", "cm_k")),
    "ia3": dict(method="ia3", targets=("k", "v", "down")),
    "prefix": dict(method="prefix", targets=("q", "v"), n_prefix=4),
}
S, R = 12, 3
TRAIN = dict(lr=1e-2, warmup_steps=1, total_steps=4, max_grad_norm=1.0,
             weight_decay=0.1, remat=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def rwkv_system():
    cfg = tiny(RWKV)
    return cfg, port_config(cfg), numpy_params(cfg, 21)


# ---------------------------------------------------------------------------
# the train makers against JAX's


def _port_run(pc, pb, name, bank, n=3):
    """``n`` steps of the port's ``make_multi_client_train_step`` from a
    numpy bank with zero moments: [(bank, opt, metrics)] after each."""
    pfn = port_sym.make_multi_client_train_step(
        pc, pcfg.AdapterConfig(**ACFGS[name]), pcfg.TrainConfig(**TRAIN))
    pbk = tree_map(_t, bank)
    po = AdamWState(step=torch.zeros(R, dtype=torch.int32),
                    m=tree_map(torch.zeros_like, pbk),
                    v=tree_map(torch.zeros_like, pbk))
    out = []
    for t, b in enumerate(batches(pc, 3, n, (R,))):
        pbk, po, pm = pfn(pb, pbk, po, tree_map(_t, b), t)
        out.append((pbk, po, pm))
    return out


@pytest.fixture(scope="module")
def multi_client_runs():
    """Three steps of ``make_multi_client_train_step`` per method in both
    packages: {method: (bank, [(port bank, opt, metrics), (JAX ...)] after
    steps 1 and 3)}."""
    cfg, pc, base = rwkv_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    jbase = jax.tree.map(jnp.asarray, base)
    out = {}
    for name in ("lora", "ia3"):
        bank = numpy_bank(cfg, JaxAdapterConfig(**ACFGS[name]), R, 5)
        jfn = jax.jit(jax_sym.make_multi_client_train_step(
            cfg, JaxAdapterConfig(**ACFGS[name]), JaxTrainConfig(**TRAIN)))
        jb = jax.tree.map(jnp.asarray, bank)
        jo = jax.vmap(jax_adamw_init)(jb)
        seen = []
        port = _port_run(pc, pb, name, bank)
        for t, b in enumerate(batches(cfg, 3, 3, (R,))):
            jb, jo, jm = jfn(jbase, jb, jo, jax.tree.map(jnp.asarray, b), t)
            if t in (0, 2):
                seen.append((port[t], (jb, jo, jm)))
        out[name] = (bank, seen)
    return out


@pytest.mark.parametrize("after", [1, 3])
@pytest.mark.parametrize("name", ["lora", "ia3"])
def test_multi_client_train_step_matches_reference(multi_client_runs, name,
                                                   after):
    """C = 3 clients on one schedule (layer remat, the recurrence's blocks
    checkpointed): losses, gnorms, bank and moments."""
    _, seen = multi_client_runs[name]
    (pbk, po, pm), (jb, jo, jm) = seen[0 if after == 1 else 1]
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), **TOL)
    np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]), **TOL)
    assert_state_close(tuple(tree_map(np.asarray, t)
                             for t in (pbk, po.m, po.v)), (jb, jo.m, jo.v))
    np.testing.assert_array_equal(po.step.numpy(), np.asarray(jo.step))


def test_prefix_bank_does_nothing_on_rwkv():
    """No RWKV layer reads a prefix (JAX's behaviour, copied): every loss
    is the bare base's, the grads are zero, so the moments stay zero and
    each step scales the state by (1 - lr x weight decay) alone."""
    from repro_torch.models.losses import lm_loss
    from repro_torch.optim import warmup_cosine
    cfg, pc, base = rwkv_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    bank = numpy_bank(cfg, JaxAdapterConfig(**ACFGS["prefix"]), R, 5)
    runs = _port_run(pc, pb, "prefix", bank)
    want = tree_map(_t, bank)
    for t, (b, (pbk, po, pm)) in enumerate(zip(batches(pc, 3, 3, (R,)),
                                              runs)):
        bare = [lm_loss(get_model(pc).forward(pb, {"tokens": _t(x)},
                                              remat=False), _t(y), None)
                for x, y in zip(b["tokens"], b["labels"])]
        np.testing.assert_allclose(pm["loss"].numpy(),
                                   torch.stack(bare).numpy(), **TOL)
        assert float(pm["gnorm"].abs().max()) == 0.0
        for m in tree_leaves(po.m) + tree_leaves(po.v):
            assert not m.any()
        lr = float(warmup_cosine(torch.tensor(t), TRAIN["lr"],
                                 TRAIN["warmup_steps"], TRAIN["total_steps"]))
        want = tree_map(lambda w: w * (1 - lr * TRAIN["weight_decay"]), want)
        for a, w in zip(tree_leaves(pbk), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL)
    for a, b0 in zip(tree_leaves(runs[-1][0]), tree_leaves(bank)):
        assert not torch.equal(a, _t(b0))        # weight decay moved it


CAP = 4
SLOTS = np.array([2, 0, 3], np.int32)
MASK = np.array([True, True, False])


def test_compact_train_step_matches_reference():
    """Two ticks of one LoRA bank: rows at slots 2 and 0 with their own
    schedules, slot 3 a padding row; at the second tick slot 0's adapter
    holds a NaN, so its row is not finite and commits nothing. Finite
    rows' losses and gnorms, every ``finite`` flag, and the bank and AdamW
    state after against JAX's ``vmap``ped step; the NaN row's and the
    untouched slots' state bit for bit as they were, in both."""
    cfg, pc, base = rwkv_system()
    jacfg = JaxAdapterConfig(**ACFGS["lora"])
    bank = numpy_bank(cfg, jacfg, CAP, 13)
    rng = np.random.default_rng(14)
    m = tree_map(lambda a: (rng.standard_normal(a.shape) * 0.01)
                 .astype(np.float32), bank)
    v = tree_map(lambda a: (rng.random(a.shape) * 1e-3).astype(np.float32),
                 bank)
    step = np.arange(CAP, dtype=np.int32) + 1
    jfn = jax.jit(jax_sym.make_compact_train_step(cfg, jacfg, remat=True))
    pfn = port_sym.make_compact_train_step(
        pc, pcfg.AdapterConfig(**ACFGS["lora"]), remat=True)
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
            tree_leaves(pbk)[0][0].view(-1)[0] = float("nan")
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


def test_chunk_contract_refuses_a_training_length():
    """A 130-token training sequence (over the 128-step chunk, no multiple
    of it) is refused by both packages' row programs, with JAX's words."""
    cfg, pc, base = rwkv_system()
    ac = ACFGS["lora"]
    bank = numpy_bank(cfg, JaxAdapterConfig(**ac), 1, 19)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 130)) \
        .astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(AssertionError, match="seq 130 % chunk 128 != 0"):
        jax_sym.make_row_grad_fn(cfg, JaxAdapterConfig(**ac))(
            jax.tree.map(lambda a: jnp.asarray(a[0]), bank),
            jax.tree.map(jnp.asarray, base),
            jax.tree.map(jnp.asarray, batch))
    with pytest.raises(ValueError, match="seq 130 % chunk 128 != 0"):
        port_sym.make_row_grad_fn(pc, pcfg.AdapterConfig(**ac))(
            tree_map(lambda a: _t(a[0]), bank),
            convert.params_from_numpy(pc, base, "cpu"),
            tree_map(_t, batch))


# ---------------------------------------------------------------------------
# the engines


class RwkvPair(Pair):
    """``Pair`` over the RWKV base: adapters drawn in JAX's layout, which is
    the port's (``layers``)."""
    system = staticmethod(rwkv_system)

    def numpy_adapter(self, ja, seed):
        return tree_map(lambda a: a[0],
                        numpy_bank(self.cfg, ja, 1, 100 + seed))


def test_finetune_engine_matches_reference():
    """Two LoRA jobs behind a router with room for one, tick by tick
    against the JAX engine: admissions, slots, steps, stats, the router
    ledgers (the port's by its own terms), losses and final states; both
    engines' events, kind by kind in order."""
    from repro.obs import Obs as JaxObs
    from repro_torch.obs import Obs
    from repro_torch.training import job_charge_bytes, job_hbm_bytes
    probe = RwkvPair()
    _, pj = probe.make(0, steps=2, seq=S, acfg=ACFGS["lora"])
    p = RwkvPair(slot_bytes=job_hbm_bytes(probe.pc, pj) * 1.5,
                 port_slot_bytes=job_charge_bytes(probe.pc, pj) * 1.5)
    for eng, obs in ((p.jax, JaxObs()), (p.port, Obs())):
        eng._obs, eng._span = obs, obs.span
        obs.attach("finetune", eng)
    p.submit(0, steps=2, seq=S, acfg=ACFGS["lora"])
    p.submit(1, steps=2, seq=S, acfg=ACFGS["lora"])      # waits for a slot
    p.tick()
    assert p.port.n_active == 1 and len(p.port._queue) == 1
    p.run()
    assert p.port.stats["train_steps"] == 4
    kinds = [[e.kind for e in eng.drain_events() if e.kind != "compile"]
             for eng in (p.jax, p.port)]
    assert kinds[0] == kinds[1]
    assert kinds[1].count("admit") == 2 == kinds[1].count("retire")


def _engine_jobs(pc, n_steps=3):
    return [FinetuneJob(acfg=pcfg.AdapterConfig(**ACFGS["lora"]),
                        batch_size=2, seq_len=S, steps=n_steps, seed=i,
                        lr=1e-2, warmup_steps=1, name=f"lora-{i}",
                        data=make_job_stream(pc, 2, S, seed=i, device="cpu"))
            for i in range(2)]


def _same_jobs(got, want):
    for a, b in zip(got, want):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)


def test_killed_job_resumes_bit_for_bit():
    """Two jobs of one bank: killed after 1 of 3 ticks, the snapshot
    pickled and loaded into a fresh engine over the same base, both jobs
    continue their uninterrupted trajectories bit for bit (losses, final
    adapters and moments, stats); the adapter tree keeps JAX's ``layers``
    layout, q resolved to r."""
    _, pc, base = rwkv_system()
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
    assert sorted(state["active"][0]["init_adapter"]["layers"]) == \
        ["cm_k", "r", "v"]
    resumed = FinetuneEngine(spec, pb, device="cpu")
    resumed.load_engine_state(state)
    done = resumed.run()
    assert [j.name for j in done] == [j.name for j in jobs]
    _same_jobs(done, jobs)
    assert resumed.stats == ref.stats


def test_symbiosis_engine_serves_beside_rwkv_jobs():
    """LoRA tenants served (the dense layout) beside two RWKV jobs on ONE
    base: every stream equals serving alone and every job its
    ``FinetuneEngine`` run alone, bit for bit."""
    from repro_torch.core.engine_spec import BankSpec
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.training import SymbiosisEngine
    cfg, pc, base = rwkv_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    pacfg = pcfg.AdapterConfig(**ACFGS["lora"])
    bank = convert.bank_from_numpy(pacfg, numpy_bank(
        cfg, JaxAdapterConfig(**ACFGS["lora"]), 2, 31), "cpu")
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, 2),),
                      serve=pcfg.ServeConfig(n_clients=2, max_seq=32),
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
    _same_jobs(jobs, solo)


def test_train_cli_trains_rwkv(capsys):
    """``--arch rwkv6-7b`` (reduced) on the CPU: two LoRA jobs take their
    steps; ``--mesh`` stays refused."""
    from repro_torch.launch import train
    train.main(["--device", "cpu", "--arch", "rwkv6-7b", "--steps", "2",
                "--clients", "2", "--seq", "16", "--layers", "2",
                "--d-model", "128"])
    out = capsys.readouterr().out
    assert "rwkv6-7b-smoke" in out and "steps=4" in out
    with pytest.raises(SystemExit, match="not ported yet"):
        train.main(["--device", "cpu", "--arch", "rwkv6-7b", "--mesh", "2",
                    "2"])


# ---------------------------------------------------------------------------
# the charge's RWKV terms against the tensors autograd saves


def act_config(dtype, n_layers=2):
    return pcfg.ModelConfig(name="t", arch="rwkv", n_layers=n_layers,
                            d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                            d_ff=96, vocab=200, dtype=dtype,
                            param_dtype=dtype)


def _step_saved_bytes(cfg, acfg, mem_opt, remat, seq):
    """Bytes of the storages autograd packs for one job's step (2 x
    ``seq`` tokens), the base and adapter leaves left out."""
    g = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_params(g, "cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not mem_opt), base)
    params = tree_map(lambda x: x.detach().requires_grad_(True),
                      port_adapters.init_adapter(cfg, acfg, g, device="cpu"))
    toks = torch.randint(0, cfg.vocab, (2, seq), generator=g)
    skip = {t.untyped_storage().data_ptr()
            for t in tree_leaves(base) + tree_leaves(params)}
    ctx = make_client_ctx(cfg, acfg, memory_optimized=mem_opt)
    with torch.enable_grad():
        (logits, aux), seen = _packed(lambda: get_model(cfg).forward(
            base, {"tokens": toks}, ctx, params, remat=remat, with_aux=True))
        _, more = _packed(lambda: lm_loss(logits, toks, None, aux))
    seen.update(more)
    return sum(t.untyped_storage().nbytes() for p, t in seen.items()
               if p not in skip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mem_opt", [True, False])
def test_rwkv_terms_count_the_saved_tensors(dtype, mem_opt):
    """A third layer (every input requiring grad behind the first layer's
    adapters) adds to a LoRA, an IA3 and a prefix step's saved tensors
    exactly ``_rwkv_saved_bytes`` (100 tokens: two checkpointed blocks,
    two carried states); one recomputed wkv block saves exactly
    ``_wkv_block_saved_bytes``; the charge stays above the step's saved
    tensors, with and without ``remat``."""
    seq = 100
    cfgs = {L: act_config(dtype, L) for L in (2, 3)}
    for name in ("lora", "ia3", "prefix"):
        acfg = pcfg.AdapterConfig(**ACFGS[name])
        got = {L: _step_saved_bytes(c, acfg, mem_opt, False, seq)
               for L, c in cfgs.items()}
        assert got[3] - got[2] == port_engine._rwkv_saved_bytes(
            cfgs[2], acfg, 2, seq, mem_opt)
        job = FinetuneJob(acfg=acfg, data=None, batch_size=2, seq_len=seq,
                          steps=1)
        for remat in (False, True):
            c = cfgs[2]
            assert job_activation_bytes(c, job, remat=remat,
                                        memory_optimized=mem_opt) >= \
                _step_saved_bytes(c, acfg, mem_opt, remat, seq)
    cfg = cfgs[2]
    H, hd, c = 4, 16, min(seq, port_rwkv.WKV_BLOCK)
    ins = [torch.randn(2, H, hd, hd), torch.randn(2, c, H, hd),
           torch.randn(2, c, H, hd), torch.randn(2, c, H, hd),
           torch.rand(2, c, H, hd), torch.randn(H, hd)]
    for t in ins:
        t.requires_grad_(True)
    with torch.enable_grad():
        _, blk = _packed(lambda: port_rwkv._wkv_block_saved(*ins))
    skip = {t.untyped_storage().data_ptr() for t in ins}
    assert sum(t.untyped_storage().nbytes() for p, t in blk.items()
               if p not in skip) == \
        port_engine._wkv_block_saved_bytes(cfg, 2, seq)
