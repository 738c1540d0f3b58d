"""PyTorch port vs the JAX reference: fine-tuning with every PEFT method
(LoRA, IA3, prefix) on the shared base.

On a tiny fp32 dense config (``conftest.tiny``), the same numpy-made base,
adapters (every leaf non-trivial) and batches go through both packages:

* the merged-batch hooks — ``apply_adapter_bank`` / ``pre_scale_bank``
  (IA3: each row's scale over its own B*S tokens) and the prefix branch on
  each sequence's row prefix (``compact_adapter_bank(per_row=B)``), with
  its grads summed per row — against JAX's ``vmap`` over the rows (R = 3,
  B = 2): the IA3 hooks bit for bit, the prefix branch and its grads at
  atol = rtol = 1e-5;
* ``make_compact_train_step`` for IA3 and prefix against JAX's (three
  ticks, rows at their own schedules, a padding row; LoRA's is in
  ``test_torch_train.py``), and, in the port, a NaN row of each committing
  nothing while the other rows equal the unpoisoned call bit for bit;
* ``make_multi_client_train_step`` per method, with and without
  ``microbatch``, and ``make_mixed_step`` (train, then a dense bank-wide
  decode) against JAX's; the port's mixed step against its two halves
  run apart, bit for bit;
* the port's ``FinetuneEngine`` against the JAX engine tick by tick with
  LoRA, IA3 and prefix banks in one engine behind a router, both with
  ``debug=True``: admissions, slots, steps, stats and router charges
  exactly, losses and final states to tolerance.

Losses, logits and metrics are held at atol = rtol = 1e-5, adapters and
AdamW moments at ``test_torch_train.assert_state_close``'s tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import ServeConfig as JaxServeConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.core import adapters as jax_adapters
from repro.core import symbiosis as jax_sym
from repro.models import blocks as jax_blocks
from repro.models import transformer as jax_tf
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.models import blocks as port_blocks
from repro_torch.models import transformer as port_tf
from repro_torch.optim import AdamWState
from repro_torch.training import (job_activation_bytes, job_charge_bytes,
                                  job_hbm_bytes, job_working_bytes)
from test_torch_finetune_engine import Pair
from test_torch_mixed_serving import numpy_adapter_bank
from test_torch_model import LOGIT_TOL, POOL_TOL
from test_torch_train import (CAP, MASK, R, SLOTS, TOL, assert_state_close,
                              batches, hyper_rows, jax_tree, port_base,
                              port_tree, system)

ACFGS = {   # the JAX package's field values, one per method
    "lora": dict(method="lora", rank=4, alpha=8.0, targets=("q", "v")),
    "ia3": dict(method="ia3", targets=("k", "v", "down")),
    "prefix": dict(method="prefix", targets=("q", "v"), n_prefix=4),
}
METHODS = sorted(ACFGS)


def acfgs(method):
    return (JaxAdapterConfig(**ACFGS[method]),
            pcfg.AdapterConfig(**ACFGS[method]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the merged-batch hooks against JAX's vmap over rows

NR, NB, NS = 3, 2, 5          # rows, sequences per row, tokens


def test_ia3_bank_hooks_match_vmap_bitwise():
    """``apply_adapter_bank`` scales each row's own B*S outputs (``down``
    untouched), ``pre_scale_bank`` each row's ``down`` input (every other
    path untouched): bit for bit JAX's vmap of ``apply_adapter`` /
    ``pre_scale``."""
    cfg, pc, _ = system()
    ja, pa = acfgs("ia3")
    rng = np.random.default_rng(3)
    kv = cfg.n_kv_heads * cfg.hd
    for path, din, dout in (("k", cfg.d_model, kv), ("v", cfg.d_model, kv),
                            ("down", cfg.d_ff, cfg.d_model)):
        n = din if path == "down" else dout
        x = rng.standard_normal((NR, NB, NS, din)).astype(np.float32)
        y = rng.standard_normal((NR, NB, NS, dout)).astype(np.float32)
        s = (1 + 0.3 * rng.standard_normal((NR, n))).astype(np.float32)

        def post(y, x, s, path=path):
            return jax_adapters.apply_adapter(y, x, path, {path: {"scale": s}},
                                              ja, cfg)

        def pre(x, s, path=path):
            return jax_adapters.pre_scale(x, path, {path: {"scale": s}}, ja,
                                          cfg)

        want_y = np.asarray(jax.vmap(post)(y, x, s))
        want_x = np.asarray(jax.vmap(pre)(x, s))
        flat = lambda a: _t(a.reshape((NR * NB,) + a.shape[2:]))
        ad = {path: {"scale": _t(s)}}
        got_y = port_adapters.apply_adapter_bank(flat(y), flat(x), path, ad,
                                                 pa, pc, NR)
        got_x = port_adapters.pre_scale_bank(flat(x), path, ad, pa, pc, NR)
        np.testing.assert_array_equal(got_y.numpy(), want_y.reshape(
            got_y.shape))
        np.testing.assert_array_equal(got_x.numpy(), want_x.reshape(
            got_x.shape))
        assert (path == "down") == np.array_equal(want_y, y)
        assert (path != "down") == np.array_equal(want_x, x)


def test_prefix_branch_matches_vmap_with_row_grads():
    """The prefix branch over R*B sequences, each given its row's prefix
    by ``compact_adapter_bank(per_row=B)``, against JAX's vmap of
    ``_prefix_attend`` over the rows (one shared prefix per row); the
    grads of a weighted sum w.r.t. the row-stacked prefix K/V, which the
    gather's backward sums over each row's B sequences, against JAX's."""
    cfg, pc, base = system()
    _, pa = acfgs("prefix")
    rng = np.random.default_rng(4)
    P, K, hd = pa.n_prefix, cfg.n_kv_heads, cfg.hd
    h = rng.standard_normal((NR, NB, NS, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((NR, NB, NS, cfg.d_model)).astype(np.float32)
    pk, pv = (rng.standard_normal((NR, cfg.n_layers, P, K, hd))
              .astype(np.float32) for _ in range(2))
    layer = 1
    jattn = jax.tree.map(lambda a: jnp.asarray(a[layer]),
                         base["layers"]["attn"])

    def jloss(pk, pv):
        out = jax.vmap(lambda hh, k, v: jax_tf._prefix_attend(
            jattn, cfg, hh, (k[layer], v[layer]), jax_blocks.DEFAULT_LIN))(
                jnp.asarray(h), pk, pv)
        return jnp.sum(out * w), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pk), jnp.asarray(pv))
    pb = port_base(pc, base)
    tk, tv = _t(pk).requires_grad_(True), _t(pv).requires_grad_(True)
    relaid = port_adapters.compact_adapter_bank(
        {"layers": {"prefix_k": tk, "prefix_v": tv}}, per_row=NB)["layers"]
    assert relaid["prefix_k"].shape == (cfg.n_layers, NR * NB, P, K, hd)
    got = port_tf._prefix_attend(
        pb["layers"][layer]["attn"], pc,
        _t(h.reshape((NR * NB,) + h.shape[2:])),
        (relaid["prefix_k"][layer], relaid["prefix_v"][layer]),
        port_blocks.DEFAULT_LIN)
    np.testing.assert_allclose(got.detach().numpy().reshape(want.shape),
                               np.asarray(want), **TOL)
    gk, gv = torch.autograd.grad((got * _t(w.reshape(got.shape))).sum(),
                                 [tk, tv])
    for g, jgl in ((gk, jg[0]), (gv, jg[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgl), **TOL)


# ---------------------------------------------------------------------------
# the compact multi-job step, per method

def method_bank(cfg, ja, lead, seed):
    """A bank of ``lead`` slots in the JAX layout with random AdamW
    moments and steps."""
    bank = numpy_adapter_bank(cfg, ja, lead, seed)
    rng = np.random.default_rng(seed + 1)
    m = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.01)
                     .astype(np.float32), bank)
    v = jax.tree.map(lambda a: (rng.random(a.shape) * 1e-3)
                     .astype(np.float32), bank)
    return bank, np.arange(lead, dtype=np.int32) + 1, m, v


def port_state(bank, step, m, v):
    return port_tree(bank), AdamWState(step=_t(step), m=port_tree(m),
                                       v=port_tree(v))


def jax_state(bank, step, m, v):
    return jax_tree(bank), JaxAdamWState(step=jnp.asarray(step),
                                         m=jax_tree(m), v=jax_tree(v))


@pytest.mark.parametrize("method", ["ia3", "prefix"])
def test_compact_train_step_matches_reference(method):
    """Three ticks of one bank (rows at slots 4, 1, 3 with their own
    schedules, decay and clipping; one padding row) against JAX's (LoRA's
    in ``test_torch_train.py``)."""
    cfg, pc, base = system()
    ja, pa = acfgs(method)
    steps = batches(cfg, 8, 3, (R,))
    state = method_bank(cfg, ja, CAP, 30)
    jfn = jax.jit(jax_sym.make_compact_train_step(cfg, ja, remat=False))
    pfn = port_sym.make_compact_train_step(pc, pa, remat=False)
    jb, jo = jax_state(*state)
    pbank, popt = port_state(*state)
    pb = port_base(pc, base)
    for t, b in enumerate(steps):
        jb, jo, jm = jfn(jax_tree(base), jb, jo, jax_tree(b),
                         jnp.asarray(SLOTS), jnp.asarray(MASK),
                         jax_tree(hyper_rows(t)))
        pbank, popt, pm = pfn(pb, pbank, popt, port_tree(b), _t(SLOTS),
                              _t(MASK), port_tree(hyper_rows(t)))
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(pm[k].numpy()[MASK],
                                       np.asarray(jm[k])[MASK], **TOL)
        assert pm["finite"].numpy()[MASK].all()
    assert_state_close((pbank, popt.m, popt.v), (jb, jo.m, jo.v))
    np.testing.assert_array_equal(popt.step.numpy(), np.asarray(jo.step))


@pytest.mark.parametrize("method", ["ia3", "prefix"])
def test_nan_row_commits_nothing(method):
    """In the port, bit for bit: a row poisoned with a NaN mask keeps its
    slot's state and is reported non-finite; the padding row's slot and
    the slots outside the call keep theirs; every other row equals the
    unpoisoned call exactly."""
    cfg, pc, base = system()
    ja, pa = acfgs(method)
    pb = port_base(pc, base)
    fn = port_sym.make_compact_train_step(pc, pa, remat=False)
    b = port_tree(batches(cfg, 10, 1, (R,))[0])
    state = method_bank(cfg, ja, CAP, 31)
    start = tree_leaves(port_state(*state))
    outs = []
    for poison in (False, True):
        bb = dict(b, mask=torch.ones(b["labels"].shape))
        if poison:
            bb["mask"][1] = float("nan")          # the row at slot 1
        outs.append(fn(pb, *port_state(*state), bb, _t(SLOTS), _t(MASK),
                       port_tree(hyper_rows(0))))
    assert outs[0][2]["finite"].all()
    assert outs[1][2]["finite"].tolist() == [True, False, True, True]
    for full, clean, before in zip(tree_leaves(outs[1][:2]),
                                   tree_leaves(outs[0][:2]), start):
        for s in (1, 0, 2, 5):                 # poisoned, padding, outside
            assert torch.equal(full[s], before[s])
        for s in (4, 3):
            assert torch.equal(full[s], clean[s])


# ---------------------------------------------------------------------------
# the multi-client step and the mixed step

NC = 2


def client_batches(cfg, seed, n, per):
    """``n`` steps of [NC, per, S] batches (``per`` 2 or 4)."""
    out = batches(cfg, seed, n, (NC,))
    if per == 4:
        more = batches(cfg, seed + 50, n, (NC,))
        out = [{k: np.concatenate([a[k], c[k]], axis=1) for k in a}
               for a, c in zip(out, more)]
    return out


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("method", METHODS)
def test_multi_client_train_step_matches_reference(method, microbatch):
    """Two steps of C=2 clients on one schedule (warmup, clipping, decay;
    ``microbatch`` 2 splits each client's 4 sequences), from a bank whose
    AdamW state JAX's ``vmap(adamw_init)`` makes: losses, gnorms and lr
    each step, the bank and both moments after."""
    cfg, pc, base = system()
    ja, pa = acfgs(method)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=6, max_grad_norm=0.5,
              weight_decay=0.05, remat=False, microbatch=microbatch)
    steps = client_batches(cfg, 12, 2, 4 if microbatch else 2)
    bank = numpy_adapter_bank(cfg, ja, NC, 32)
    jfn = jax.jit(jax_sym.make_multi_client_train_step(
        cfg, ja, JaxTrainConfig(n_clients=NC, **kw)))
    pfn = port_sym.make_multi_client_train_step(pc, pa, pcfg.TrainConfig(**kw))
    jb = jax_tree(bank)
    jo = jax.vmap(jax_adamw_init)(jb)
    pbank = port_tree(bank)
    popt = AdamWState(step=torch.zeros(NC, dtype=torch.int32),
                      m=tree_map(torch.zeros_like, pbank),
                      v=tree_map(torch.zeros_like, pbank))
    pb = port_base(pc, base)
    for t, b in enumerate(steps, start=1):
        jb, jo, jm = jfn(jax_tree(base), jb, jo, jax_tree(b), t)
        pbank, popt, pm = pfn(pb, pbank, popt, port_tree(b), t)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]), **TOL)
    assert_state_close((pbank, popt.m, popt.v), (jb, jo.m, jo.v))
    np.testing.assert_array_equal(popt.step.numpy(), np.asarray(jo.step))


@pytest.mark.parametrize("method", METHODS)
def test_mixed_step_matches_reference_and_its_halves(method):
    """JAX's ``make_mixed_step`` (a train step of 2 clients, then every
    slot of a dense 2-client bank decodes one token) against the port's:
    metrics, logits, caches and states; and the port's mixed step against
    its train step and decode step run apart, bit for bit."""
    cfg, pc, base = system()
    ja, pa = acfgs(method)
    tkw = dict(lr=1e-2, warmup_steps=1, remat=False)
    jt, pt = JaxTrainConfig(n_clients=NC, **tkw), pcfg.TrainConfig(**tkw)
    js = JaxServeConfig(n_clients=NC, max_seq=16)
    ps = pcfg.ServeConfig(n_clients=NC, max_seq=16)
    ft = numpy_adapter_bank(cfg, ja, NC, 33)
    inf = numpy_adapter_bank(cfg, ja, NC, 34)
    b = client_batches(cfg, 14, 1, 2)[0]
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, (NC, 2)).astype(np.int32)
    jc = jax_sym.init_client_caches(cfg, NC, 2, 16)
    jfb, jfo = jax_tree(ft), jax.vmap(jax_adamw_init)(jax_tree(ft))
    out = jax.jit(jax_sym.make_mixed_step(cfg, ja, jt, js))(
        jax_tree(base), jfb, jfo, jax_tree(b), jax_tree(inf), jc,
        jnp.asarray(toks), 1)
    pb = port_base(pc, base)

    def port_inputs():
        fb = port_tree(ft)
        return (fb, adamw_init_bank(fb), port_tree(b), port_tree(inf),
                port_sym.init_client_caches(pc, NC, 2, 16, device="cpu"),
                _t(toks))

    fb, fo, pbatch, ib, caches, pt_toks = port_inputs()
    got = port_sym.make_mixed_step(pc, pa, pt, ps)(pb, fb, fo, pbatch, ib,
                                                   caches, pt_toks, 1)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(out[3]),
                               **LOGIT_TOL)
    for k in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(got[4][k].numpy(), np.asarray(out[4][k]),
                                   **TOL)
    assert_state_close((got[0], got[1].m, got[1].v),
                       (out[0], out[1].m, out[1].v))
    pc_np, jc_np = convert.caches_to_numpy(got[2]), jax.tree.map(np.asarray,
                                                                out[2])
    np.testing.assert_array_equal(pc_np["pos"], jc_np["pos"])
    for n in ("k", "v"):
        np.testing.assert_allclose(pc_np["layers"][n], jc_np["layers"][n],
                                   **POOL_TOL)
    # the same programs run apart
    fb, fo, pbatch, ib, caches, pt_toks = port_inputs()
    a_bank, a_opt, a_m = port_sym.make_multi_client_train_step(pc, pa, pt)(
        pb, fb, fo, pbatch, 1)
    a_logits, a_caches = port_sym.make_multi_client_decode_step(pc, pa, ps)(
        pb, ib, caches, pt_toks)
    for x, y in zip(tree_leaves((a_bank, a_opt, a_caches, a_logits,
                                 a_m["loss"], a_m["gnorm"])),
                    tree_leaves((got[0], got[1], got[2], got[3],
                                 got[4]["loss"], got[4]["gnorm"]))):
        assert torch.equal(x, y)


def adamw_init_bank(bank):
    """JAX's ``vmap(adamw_init)`` in the port: zero moments, steps [C]."""
    C = tree_leaves(bank)[0].shape[0]
    return AdamWState(step=torch.zeros(C, dtype=torch.int32),
                      m=tree_map(torch.zeros_like, bank),
                      v=tree_map(torch.zeros_like, bank))


# ---------------------------------------------------------------------------
# the engine with LoRA, IA3 and prefix banks against the JAX engine

class MethodsPair(Pair):
    """``Pair`` whose jobs start from a non-trivial adapter of their own
    method, both engines auditing conservation after every tick."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.jax.debug = self.port.debug = True

    def numpy_adapter(self, ja, seed):
        return jax.tree.map(lambda a: a[0],
                            numpy_adapter_bank(self.cfg, ja, 1, 100 + seed))


def test_engine_with_every_method_matches_reference():
    """Two jobs of each method (one joining mid-run), a prefix job whose
    stream ends early, an IA3 job poisoned at its second batch, behind a
    router that holds the last job back until a charge frees: host state
    exactly, losses and final states to tolerance, tick by tick."""
    _, pc, _ = system()
    first = ("lora", "ia3", "prefix", "ia3", "prefix")
    probe = MethodsPair()
    jobs = [probe.make(i, acfg=ACFGS[m])[1] for i, m in enumerate(first)]
    charges = [job_hbm_bytes(pc, j) for j in jobs]
    assert len(set(charges)) == 3              # each method its own charge
    port_charges = [job_charge_bytes(pc, j) for j in jobs]
    assert [b - a for a, b in zip(charges, port_charges)] == \
        [job_activation_bytes(pc, j) + job_working_bytes(pc, j)
         for j in jobs]
    # the same slack over the first five jobs' charges in both ledgers
    p = MethodsPair(slot_bytes=sum(charges) * 1.01,
                    port_slot_bytes=sum(port_charges) + sum(charges) * 0.01)
    # every stream is a fault stream (one bank's batches share their keys)
    p.submit(0, steps=3, acfg=ACFGS["lora"], faults={})
    p.submit(1, steps=3, acfg=ACFGS["ia3"], faults={1: "nan_batch"})
    p.submit(2, steps=3, acfg=ACFGS["prefix"], faults={})
    p.submit(3, steps=4, acfg=ACFGS["ia3"], faults={})
    p.submit(4, steps=4, acfg=ACFGS["prefix"], faults={2: "stream_end"})
    p.tick()
    p.submit(5, steps=2, acfg=ACFGS["ia3"], faults={})
    p.submit(6, steps=2, acfg=ACFGS["lora"], faults={})
    p.run()
    assert [pj.status for _, pj in p.jobs] == [
        "finished", "quarantined", "finished", "finished", "finished_early",
        "finished", "finished"]
    assert len(p.port._banks) == 3
    assert p.port.stats["peak_jobs"] == 5 and p.port.stats["quarantined"] == 1
    assert not p.routers[1]._committed
