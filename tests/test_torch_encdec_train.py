"""PyTorch port vs the JAX reference: the encoder-decoder family's
fine-tuning, on the CPU (``tiny(ENCDEC)``, fp32).

Against JAX: ``make_multi_client_train_step`` (with and without
``microbatch``, which slices each row's frames beside its tokens) and
``make_mixed_step`` (that train step, then the dense multi-client decode)
on C = 3 clients; the compacted train step of one LoRA bank with a padding
row; a ``FinetuneEngine`` with 2 LoRA, 2 IA3 and 2 prefix jobs behind a
router tick by tick (``EncdecPair``: each port job's stream hands out
JAX's frames), losses, final adapters and AdamW state; ``job_hbm_bytes``
equal to JAX's; a job checkpoint written by either package restored by
the other.

Within the port: the charge's ``_encdec_saved_bytes`` against the
storages autograd packs (a third decoder layer's difference, a third
encoder layer's, one recomputed encoder layer), in fp32 and bf16, with
and without §3.6, and the charge above the whole step's saved tensors
with and without ``remat``; a killed engine resumed from ``engine_state``
bit for bit; a ``SymbiosisEngine`` training its jobs as the
``FinetuneEngine`` alone does; the train CLI on whisper-small (reduced).
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import ServeConfig as JaxServeConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.core import symbiosis as jax_sym
from repro.data import SyntheticLMDataset as JaxDataset
from repro.data.pipeline import frontend_stub as jax_frontend_stub
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro.training.engine import job_hbm_bytes as jax_job_hbm_bytes
from repro.training.job import FinetuneJob as JaxJob
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.checkpoint import restore_job_state, save_job_state
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import encdec as port_encdec
from repro_torch.models import get_model
from repro_torch.models.losses import lm_loss
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.training import (FinetuneEngine, FinetuneJob,
                                  job_activation_bytes, job_charge_bytes,
                                  job_hbm_bytes, make_job_stream)
from repro_torch.training import engine as port_engine
from test_torch_encdec import CFG, assert_cache_close, numpy_bank, \
    numpy_params
from test_torch_finetune_engine import Pair
from test_torch_hybrid import _t
from test_torch_moe_train import _packed
from test_torch_model import port_config
from test_torch_rwkv import one_thread  # noqa: F401 (autouse fixture)
from test_torch_train import assert_state_close

TOL = dict(atol=1e-5, rtol=1e-5)
ACFGS = {
    "lora": dict(method="lora", rank=4, alpha=8.0, targets=("q", "v")),
    "ia3": dict(method="ia3", targets=("k", "v", "down")),
    "prefix": dict(method="prefix", targets=("q", "v"), n_prefix=4),
}
S, B, R = 6, 2, 3
TRAIN = dict(lr=1e-2, warmup_steps=1, total_steps=4, max_grad_norm=1.0,
             weight_decay=0.1, remat=True)


def encdec_system():
    return CFG, port_config(CFG), numpy_params(CFG, 21)


def batches(cfg, seed, n, lead):
    """``n`` steps of tokens / labels [*lead, B, S] from the synthetic
    pipeline and JAX's frames [*lead, B, Te, d] (one draw for every
    step, as the pipeline's stub)."""
    C = int(np.prod(lead))
    ds = JaxDataset(vocab=cfg.vocab, seq_len=S, n_clients=C,
                    batch_per_client=B, seed=seed)
    frames = np.asarray(jax_frontend_stub(cfg, C, B, seed=seed)["frames"])
    return [{**{k: np.array(v).reshape(lead + v.shape[1:])
                for k, v in ds.batch(t).items()},
             "frames": frames.reshape(lead + frames.shape[1:])}
            for t in range(n)]


# ---------------------------------------------------------------------------
# the train makers against JAX's


@pytest.mark.parametrize("microbatch", [0, pytest.param(2, marks=pytest.mark.tier2)])
def test_multi_client_train_and_mixed_step_match_reference(microbatch):
    """A step of ``make_multi_client_train_step`` on 3 LoRA clients
    (``microbatch=2``: each client's 2 rows in halves, frames sliced
    alike), then ``make_mixed_step``'s train half and dense decode half
    over a bank prefilled through ``make_multi_client_prefill``: losses,
    gnorms, bank, moments, decode logits and caches against JAX's."""
    cfg, pc, base = encdec_system()
    jacfg = JaxAdapterConfig(**ACFGS["lora"])
    pacfg = pcfg.AdapterConfig(**ACFGS["lora"])
    tcfg = dict(TRAIN, microbatch=microbatch)
    bank = numpy_bank(cfg, jacfg, R, 5)
    jbase, pb = jax.tree.map(jnp.asarray, base), \
        convert.params_from_numpy(pc, base, "cpu")
    jb = jax.tree.map(jnp.asarray, bank)
    jo = jax.vmap(jax_adamw_init)(jb)
    pbk = tree_map(_t, bank)
    po = AdamWState(step=torch.zeros(R, dtype=torch.int32),
                    m=tree_map(torch.zeros_like, pbk),
                    v=tree_map(torch.zeros_like, pbk))
    jfn = jax.jit(jax_sym.make_multi_client_train_step(
        cfg, jacfg, JaxTrainConfig(**tcfg)))
    pfn = port_sym.make_multi_client_train_step(pc, pacfg,
                                                pcfg.TrainConfig(**tcfg))
    data = batches(cfg, 3, 2, (R,))
    for t, b in enumerate(data[:1]):
        jb, jo, jm = jfn(jbase, jb, jo, jax.tree.map(jnp.asarray, b), t)
        pbk, po, pm = pfn(pb, pbk, po, tree_map(_t, b), t)
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]),
                                       **TOL)
    assert_state_close(tuple(tree_map(np.asarray, x)
                             for x in (pbk, po.m, po.v)), (jb, jo.m, jo.v))
    # the mixed step: the same train step, then every slot of an
    # inference bank decodes one token on the dense layout
    scfg = JaxServeConfig(n_clients=R, max_seq=16)
    pscfg = pcfg.ServeConfig(n_clients=R, max_seq=16)
    inf = numpy_bank(cfg, jacfg, R, 7)
    jinf, pinf = jax.tree.map(jnp.asarray, inf), tree_map(_t, inf)
    prompt = {"tokens": data[1]["tokens"][..., :4],
              "frames": data[1]["frames"]}
    _, jc = jax.jit(jax_sym.make_multi_client_prefill(cfg, jacfg, scfg))(
        jbase, jinf, jax_sym.init_client_caches(cfg, R, B, 16),
        jax.tree.map(jnp.asarray, prompt))
    _, pcaches = port_sym.make_multi_client_prefill(pc, pacfg, pscfg)(
        pb, pinf, port_sym.init_client_caches(pc, R, B, 16, device="cpu"),
        tree_map(_t, prompt))
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (R, B)).astype(
        np.int32)
    jmixed = jax.jit(jax_sym.make_mixed_step(cfg, jacfg,
                                             JaxTrainConfig(**tcfg), scfg))
    pmixed = port_sym.make_mixed_step(pc, pacfg, pcfg.TrainConfig(**tcfg),
                                      pscfg)
    jb, jo, jc, jl, jm = jmixed(jbase, jb, jo, jax.tree.map(
        jnp.asarray, data[1]), jinf, jc, jnp.asarray(tok), 1)
    pbk, po, pcaches, pl, pm = pmixed(pb, pbk, po, tree_map(_t, data[1]),
                                      pinf, pcaches, _t(tok), 1)
    np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]),
                               **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(pcaches, jc)
    assert_state_close(tuple(tree_map(np.asarray, x)
                             for x in (pbk, po.m, po.v)), (jb, jo.m, jo.v))


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


@pytest.mark.parametrize("name", ["lora", pytest.param(
    "ia3", marks=pytest.mark.tier2)])
def test_compact_train_step_matches_reference(name):
    """Two ticks of one bank, rows at slots 2 and 0 with their own
    schedules and frames, slot 3 a padding row: losses, gnorms, ``finite``
    and the rows' bank and AdamW state against JAX's; the padding row's
    and the untouched slots' state bit for bit as they were."""
    cfg, pc, base = encdec_system()
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
    jo = JaxAdamWState(step=jnp.asarray(step), m=jax.tree.map(jnp.asarray, m),
                       v=jax.tree.map(jnp.asarray, v))
    pbk = tree_map(_t, bank)
    po = AdamWState(step=_t(step), m=tree_map(_t, m), v=tree_map(_t, v))
    before = [x.clone() for x in tree_leaves((pbk, po))]
    jbase, pb = jax.tree.map(jnp.asarray, base), \
        convert.params_from_numpy(pc, base, "cpu")
    for t, b in enumerate(batches(cfg, 15, 2, (R,))):
        jb, jo, jm = jfn(jbase, jb, jo, jax.tree.map(jnp.asarray, b),
                         jnp.asarray(SLOTS), jnp.asarray(MASK),
                         jax.tree.map(jnp.asarray, _hyper(t)))
        pbk, po, pm = pfn(pb, pbk, po, tree_map(_t, b), _t(SLOTS), _t(MASK),
                          tree_map(_t, _hyper(t)))
        np.testing.assert_array_equal(pm["finite"].numpy(),
                                      np.asarray(jm["finite"]))
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(pm[k].numpy()[MASK],
                                       np.asarray(jm[k])[MASK], **TOL)
    for a, c in zip(tree_leaves((pbk, po)), before):
        for s_ in (1, 3):
            assert torch.equal(a[s_], c[s_])
    rows = np.array([0, 2])
    assert_state_close(tuple(tree_map(lambda x: np.asarray(x[rows]), tr)
                             for tr in (pbk, po.m, po.v)),
                       tuple(jax.tree.map(lambda x: x[rows], tr)
                             for tr in (jb, jo.m, jo.v)))


# ---------------------------------------------------------------------------
# the engines


class EncdecPair(Pair):
    """``Pair`` over the enc-dec base: adapters drawn in both packages'
    layout (``enc_layers`` / ``dec_layers``); each port job's stream hands
    out JAX's frames (the tokens are already the same)."""
    system = staticmethod(encdec_system)

    def numpy_adapter(self, ja, seed):
        return tree_map(lambda a: a[0],
                        numpy_bank(self.cfg, ja, 1, 100 + seed))

    def port_stream(self, stream, seed):
        frames = jax_frontend_stub(self.cfg, 1,
                                   stream._stream.ds.batch_per_client,
                                   seed=seed)["frames"]
        stream._stream.extra["frames"] = _t(frames)
        return stream


def test_finetune_engine_matches_reference():
    """Two LoRA, two IA3 and two prefix jobs behind a router with room for
    all but the last, tick by tick against the JAX engine: admissions, slots,
    steps, stats, the router ledgers (the port's by its own terms), the
    losses, and the final adapters and AdamW states. A prefix job, which
    no layer reads, moves by weight decay alone in both."""
    probe = EncdecPair()
    jobs = {n: probe.make(0, seq=S, acfg=a)[1] for n, a in ACFGS.items()}
    charges = {n: (job_hbm_bytes(probe.pc, j), job_charge_bytes(probe.pc, j))
               for n, j in jobs.items()}
    jslot = 2 * sum(c[0] for c in charges.values()) - 1
    pslot = 2 * sum(c[1] for c in charges.values()) - 1
    p = EncdecPair(slot_bytes=jslot, port_slot_bytes=pslot)
    for i, name in enumerate(["lora", "ia3", "prefix"] * 2):
        p.submit(i, steps=2, seq=S, acfg=ACFGS[name], weight_decay=0.1)
    p.tick()
    assert p.port.n_active == 5 and len(p.port._queue) == 1
    p.run()
    assert p.port.stats["train_steps"] == 12


def test_job_hbm_bytes_matches_reference():
    """JAX's admission estimate, term for term, at tiny size and for
    whisper-small."""
    from repro.configs import get_config as jax_get_config
    for jc in (CFG, jax_get_config("whisper-small")):
        pc = port_config(jc)
        for name, a in ACFGS.items():
            kw = dict(batch_size=2, seq_len=128, steps=1)
            for remat in (False, True):
                assert job_hbm_bytes(pc, FinetuneJob(
                    acfg=pcfg.AdapterConfig(**a), data=None, **kw),
                    remat=remat) == jax_job_hbm_bytes(jc, JaxJob(
                        acfg=JaxAdapterConfig(**a), data=None, **kw),
                        remat=remat)


def test_job_checkpoint_crosses_both_ways(tmp_path):
    """A LoRA job's adapter (``enc_layers`` and ``dec_layers``) and AdamW
    state written by either package restore in the other, with the same
    manifest."""
    cfg, pc, _ = encdec_system()
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
    d = str(tmp_path)
    jpath = jax_ckpt.save_job_state(os.path.join(d, "j"), 5, jad, jopt,
                                    name="t")
    ppath = save_job_state(os.path.join(d, "p"), 5, pad, popt, name="t",
                           cfg=pc)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(ppath, "manifest.json")) as f:
        assert json.load(f) == jm
    text = json.dumps(jm)
    assert "enc_layers" in text and "dec_layers" in text
    like = tree_map(torch.zeros_like, pad)
    got_ad, got_opt = restore_job_state(os.path.join(d, "j"), 5, like,
                                        adamw_init(like), name="t",
                                        device="cpu", cfg=pc)
    for a, b in zip(tree_leaves((got_ad, got_opt)), tree_leaves((pad, popt))):
        assert torch.equal(a, b)
    jgot_ad, jgot_opt = jax_ckpt.restore_job_state(os.path.join(d, "p"), 5,
                                                   jad, jopt, name="t")
    for a, b in zip(jax.tree.leaves((jgot_ad, jgot_opt)),
                    jax.tree.leaves((jad, jopt))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _engine_jobs(pc, n_steps=3):
    return [FinetuneJob(acfg=pcfg.AdapterConfig(**ACFGS[name]),
                        batch_size=2, seq_len=S, steps=n_steps, seed=i,
                        lr=1e-2, warmup_steps=1, name=f"{name}-{i}",
                        data=make_job_stream(pc, 2, S, seed=i, device="cpu"))
            for i, name in enumerate(("lora", "lora", "ia3"))]


def _same_jobs(got, want):
    for a, b in zip(got, want):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)


def test_killed_engine_resumes_bit_for_bit():
    """Two LoRA jobs and an IA3 job (the port's frame draw): killed after
    1 of 3 ticks, the snapshot pickled and loaded into a fresh engine over
    the same base, every job continues its uninterrupted trajectory bit
    for bit (losses, final adapters and moments, stats)."""
    _, pc, base = encdec_system()
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
    assert sorted(state["active"][0]["init_adapter"]) == \
        ["dec_layers", "enc_layers"]
    resumed = FinetuneEngine(spec, pb, device="cpu")
    resumed.load_engine_state(state)
    done = resumed.run()
    assert [j.name for j in done] == [j.name for j in jobs]
    _same_jobs(done, jobs)
    assert resumed.stats == ref.stats


def test_symbiosis_engine_trains_encdec_jobs():
    """A ``SymbiosisEngine`` over whisper's backbone: its serving engine
    builds (and refuses requests: no frames), its fine-tuning engine
    trains every job bit for bit as a ``FinetuneEngine`` alone does."""
    from repro_torch.serving.engine import Request
    from repro_torch.training import SymbiosisEngine
    cfg, pc, base = encdec_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    pacfg = pcfg.AdapterConfig(**ACFGS["lora"])
    bank = convert.bank_from_numpy(pacfg, numpy_bank(
        cfg, JaxAdapterConfig(**ACFGS["lora"]), 2, 31), "cpu")
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, 2),),
                      serve=pcfg.ServeConfig(n_clients=2, max_seq=32),
                      finetune=pcfg.FinetuneConfig(), max_batch_per_client=2)
    sym = SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                    device="cpu")
    with pytest.raises(ValueError, match="frames"):
        sym.submit(Request(client_id=0, max_new_tokens=2,
                           prompt=np.ones((1, 4), np.int32)))
    jobs = _engine_jobs(pc, 2)
    for j in jobs:
        sym.submit(j)
    done_r, done_j = sym.run()
    assert done_r == [] and len(done_j) == 3
    ft = FinetuneEngine(spec, pb, device="cpu")
    solo = _engine_jobs(pc, 2)
    for j in solo:
        ft.submit(j)
    ft.run()
    _same_jobs(jobs, solo)


def test_train_cli_trains_whisper(capsys):
    """``--arch whisper-small`` (reduced: 2 + 2 layers, d 128, 16 frames)
    on the CPU: two LoRA jobs take their steps."""
    from repro_torch.launch import train
    train.main(["--device", "cpu", "--arch", "whisper-small", "--steps", "2",
                "--clients", "2", "--seq", "8", "--layers", "2",
                "--d-model", "128"])
    out = capsys.readouterr().out
    assert "whisper-small-smoke" in out and "steps=4" in out


# ---------------------------------------------------------------------------
# the charge's enc-dec terms against the tensors autograd saves


def act_config(dtype, n_layers=2, n_enc_layers=2):
    return pcfg.ModelConfig(name="t", arch="encdec", n_layers=n_layers,
                            n_enc_layers=n_enc_layers, d_model=64, n_heads=4,
                            n_kv_heads=4, d_ff=96, vocab=200,
                            n_frontend_tokens=24, rope_theta=0.0,
                            dtype=dtype, param_dtype=dtype)


def _step_saved_bytes(cfg, acfg, mem_opt, remat, seq=10):
    """Bytes of the storages autograd packs for one job's step (2 rows of
    ``seq`` tokens and 24 frames), the base and adapter leaves left
    out."""
    g = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_params(g, "cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not mem_opt), base)
    params = tree_map(lambda x: x.detach().requires_grad_(True),
                      port_adapters.init_adapter(cfg, acfg, g, device="cpu"))
    toks = torch.randint(0, cfg.vocab, (2, seq), generator=g)
    frames = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model),
                         generator=g).to(getattr(torch, cfg.dtype))
    skip = {t.untyped_storage().data_ptr()
            for t in tree_leaves(base) + tree_leaves(params)}
    ctx = make_client_ctx(cfg, acfg, memory_optimized=mem_opt)
    with torch.enable_grad():
        (logits, aux), seen = _packed(lambda: get_model(cfg).forward(
            base, {"tokens": toks, "frames": frames}, ctx, params,
            remat=remat, with_aux=True))
        _, more = _packed(lambda: lm_loss(logits, toks, None, aux))
    seen.update(more)
    return sum(t.untyped_storage().nbytes() for p, t in seen.items()
               if p not in skip)


def _enc_layer_saved_bytes(cfg, acfg, mem_opt):
    """Bytes one encoder layer saves when its backward recomputes it (its
    input, which the checkpoint holds, left out)."""
    g = torch.Generator().manual_seed(1)
    base = get_model(cfg).init_params(g, "cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not mem_opt), base)
    ad = tree_map(lambda x: x.detach().requires_grad_(True),
                  port_adapters.init_adapter(cfg, acfg, g, device="cpu"))
    Te = cfg.n_frontend_tokens
    x = torch.randn((2, Te, cfg.d_model), generator=g).to(
        getattr(torch, cfg.dtype)).requires_grad_(True)
    skip = {t.untyped_storage().data_ptr()
            for t in tree_leaves(base) + tree_leaves(ad) + [x]}
    lin = make_client_ctx(cfg, acfg, memory_optimized=mem_opt).for_layer(
        port_encdec._layer_adapter(ad, "enc_layers", 0))
    pos = torch.arange(Te)[None].expand(2, Te)
    with torch.enable_grad():
        _, seen = _packed(lambda: port_encdec._enc_layer(
            base["enc_layers"][0], cfg, x, pos, lin))
    return sum(t.untyped_storage().nbytes() for p, t in seen.items()
               if p not in skip)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mem_opt", [True, False])
def test_encdec_terms_count_the_saved_tensors(dtype, mem_opt):
    """A third decoder layer adds to a LoRA, an IA3 and a prefix step's
    saved tensors exactly ``_encdec_saved_bytes(..., Te=)`` (its self
    attention, its cross K/V and softmax over the 24 frames, its GELU); a
    third encoder layer adds exactly its checkpointed input; one encoder
    layer recomputed in the backward saves ``_encdec_saved_bytes`` over
    the frames (in an fp32 model its first norm's input is that layer
    input); the charge stays above the step's saved tensors, with and
    without ``remat``. Under §3.6 a prefix job records nothing."""
    seq, c = 10, act_config(dtype)
    a = 4 if dtype == "float32" else 2
    TE = 2 * c.n_frontend_tokens
    for name in ("lora", "ia3", "prefix"):
        acfg = pcfg.AdapterConfig(**ACFGS[name])
        base = _step_saved_bytes(c, acfg, mem_opt, False, seq)
        dec = _step_saved_bytes(act_config(dtype, 3, 2), acfg, mem_opt,
                                False, seq) - base
        enc = _step_saved_bytes(act_config(dtype, 2, 3), acfg, mem_opt,
                                False, seq) - base
        want = port_engine._encdec_saved_bytes(c, acfg, 2, seq, mem_opt,
                                               Te=c.n_frontend_tokens)
        assert dec == want
        inert = mem_opt and name == "prefix"
        assert enc == (0 if inert else TE * c.d_model * a)
        one = port_engine._encdec_saved_bytes(c, acfg, 2, c.n_frontend_tokens,
                                              mem_opt)
        if not inert:
            assert _enc_layer_saved_bytes(c, acfg, mem_opt) + (
                TE * c.d_model * 4 if a == 4 else 0) == one
        job = FinetuneJob(acfg=acfg, data=None, batch_size=2, seq_len=seq,
                          steps=1)
        for remat in (False, True):
            assert job_activation_bytes(c, job, remat=remat,
                                        memory_optimized=mem_opt) >= \
                _step_saved_bytes(c, acfg, mem_opt, remat, seq)
