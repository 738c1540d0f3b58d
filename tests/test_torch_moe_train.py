"""PyTorch port vs the JAX reference: the MoE family fine-tunes on the
shared base, on the CPU.

Checked on ``tiny(MOE)`` (3 layers, the first dense, 4 experts top-2, 1
shared expert), fp32, base and adapters drawn by numpy
(``test_torch_moe.numpy_params`` / ``numpy_bank``, the port's layout;
JAX's splits the first layer off as ``pre_layers``), batches from the
synthetic pipeline both packages draw alike. Against JAX at atol = rtol =
1e-5 (states after optimizer steps as ``test_torch_train.assert_state_close``
holds them):

* ``moe_forward``'s output, aux loss and grads (x, and a router LoRA's A
  and B) against ``jax.grad`` of JAX's, both dispatches, drop-free and at
  capacity factors 1.25 and 0.25 (dropping);
* ``make_row_grad_fn``, ``make_baseline_train_step`` and
  ``make_compact_train_step`` with LoRA on q, v and the router, IA3 and
  prefix, and ``make_multi_client_train_step`` at its default
  ``capacity_factor=1.25``;
* the ``FinetuneEngine`` tick by tick (``test_torch_finetune_engine.Pair``
  over the MoE base): admissions, slots, steps, stats and JAX's charge
  exactly, losses and states to tolerance.

Within the port, bit for bit: a grouped ``moe_forward`` (``rows=R``) and a
merged bank step give each row what it gets alone (its own capacity,
drops and aux); the recomputed body saves only its inputs
(``saved_tensors_hooks``) and the serving path runs the body alone; a
``SymbiosisEngine`` over the MoE base serves every stream as serving alone
does. The activation charge's MoE terms are held against the tensors
autograd saves, and a job checkpoint crosses both ways with JAX's. Sweeps
of the other makers and methods run under ``-m tier2``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import MOE
from repro.config import TrainConfig as JaxTrainConfig
from repro.checkpoint import ckpt as jax_ckpt
from repro.core import symbiosis as jax_sym
from repro.core import virtlayer as jax_virt
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import moe as jax_moe
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.checkpoint import restore_job_state, save_job_state
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.core.virtlayer import make_bank_ctx, make_client_ctx
from repro_torch.models import moe as port_moe
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import (FinetuneEngine, FinetuneJob,
                                  SymbiosisEngine, make_job_stream)
from conftest import tiny
from test_torch_finetune_engine import Pair
from test_torch_mixed_serving import port_acfg
from test_torch_model import port_config
from test_torch_moe import _moe_inputs, jax_bank, numpy_bank, numpy_params
from test_torch_train import assert_state_close
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
ACFGS = {
    "lora": dict(method="lora", rank=4, alpha=8.0,
                 targets=("q", "v", "router")),
    "ia3": dict(method="ia3", targets=("k", "v", "down")),
    "prefix": dict(method="prefix", targets=("q", "v"), n_prefix=4),
}
B, S = 2, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def moe_system():
    cfg = tiny(MOE)
    return cfg, port_config(cfg), numpy_params(cfg, 21)


def jax_layout(cfg, tree):
    """One adapter-shaped numpy tree of the port ([L, ...] leaves) in JAX's
    layout (``pre_layers`` split off)."""
    return convert._split_pre(tree, 0, cfg.first_dense_layers)


def adapters(cfg, name, n, seed):
    """(port numpy bank [n, L, ...], its JAX-layout twin)."""
    bank = numpy_bank(cfg, JaxAdapterConfig(**ACFGS[name]), n, seed)
    return bank, jax_bank(cfg, bank)


def batches(cfg, seed, n, lead):
    ds = JaxDataset(vocab=cfg.vocab, seq_len=S, n_clients=int(np.prod(lead)),
                    batch_per_client=B, seed=seed)
    return [{k: np.array(v).reshape(lead + v.shape[1:])
             for k, v in ds.batch(t).items()} for t in range(n)]


def router_lora(cfg, rows, seed):
    """Router LoRA leaves [*rows, d, r] / [*rows, r, E], B non-zero."""
    rng = np.random.default_rng(seed)
    d, E, r = cfg.d_model, cfg.n_experts, 4
    return {"router": {
        "A": (rng.standard_normal(rows + (d, r)) / np.sqrt(d))
        .astype(np.float32),
        "B": (rng.standard_normal(rows + (r, E)) * 0.3).astype(np.float32)}}


ROUTER = JaxAdapterConfig(method="lora", rank=4, alpha=8.0,
                          targets=("router",))


# ---------------------------------------------------------------------------
# moe_forward under autograd


def _cotangent(shape):
    return np.random.default_rng(9).standard_normal(shape).astype(np.float32)


def _port_moe(pp, pc, x, ad, lin_of, g=None, **kw):
    """Port moe_forward on x with router LoRA leaves ``ad`` (requiring
    grad): (y, aux, dx, dA, dB) for the loss sum(y * g) + 0.5 * sum(aux)."""
    x = x.clone().requires_grad_(True)
    leaves = [ad["router"]["A"].clone().requires_grad_(True),
              ad["router"]["B"].clone().requires_grad_(True)]
    sl = {"router": {"A": leaves[0], "B": leaves[1]}}
    y, aux = port_moe.moe_forward(pp, pc, x, lin_of(sl), **kw)
    if g is None:
        g = torch.from_numpy(_cotangent(tuple(y.shape)))
    grads = torch.autograd.grad((y * g).sum() + 0.5 * aux.sum(),
                                [x] + leaves)
    return (y.detach(), aux.detach()) + tuple(grads)


@pytest.mark.parametrize("capacity", [None, 1.25, 0.25])
@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_forward_grads_match_reference(dispatch, capacity):
    """40 tokens; at 0.25 each expert keeps 8 of ~20 slots."""
    cfg = tiny(MOE)
    pc = port_config(cfg)
    p, x = _moe_inputs(cfg, 40, 3)
    ad = router_lora(cfg, (), 4)
    jctx = jax_virt.make_client_ctx(cfg, ROUTER)

    def loss(x, ad):
        y, aux = jax_moe.moe_forward(jax.tree.map(jnp.asarray, p), cfg, x,
                                     jctx.for_layer(ad),
                                     capacity_factor=capacity,
                                     dispatch=dispatch)
        return jnp.sum(y * _cotangent(y.shape)) + 0.5 * aux, (y, aux)

    (_, (jy, jaux)), (jdx, jdad) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             jax.tree.map(jnp.asarray, ad))
    pctx = make_client_ctx(pc, port_acfg(ROUTER))
    got = _port_moe(jax.tree.map(_t, p), pc, _t(x), tree_map(_t, ad),
                    pctx.for_layer, capacity_factor=capacity,
                    dispatch=dispatch)
    want = (jy, jaux, jdx, jdad["router"]["A"], jdad["router"]["B"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    if capacity == 0.25:            # the case does drop
        _, idx, _ = port_moe._route(jax.tree.map(_t, p), pc, _t(x),
                                    port_moe.blocks.DEFAULT_LIN, "")
        cap = port_moe._capacity(40, cfg.n_experts, cfg.top_k, capacity)
        assert not port_moe._slot_positions(idx, cfg.n_experts, cap)[1].all()


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("capacity", [None, 0.5])
def test_grouped_rows_equal_each_row_alone(capacity, dispatch):
    """``rows=3`` over 3 rows x 2 sequences, each row with its own router
    LoRA through the merged bank context: every row's output, aux and
    grads equal that row run alone, bit for bit; aux is [3]; at 0.5 the
    rows drop tokens, each as its own capacity says."""
    cfg = tiny(MOE)
    pc = port_config(cfg)
    R = 3
    p, _ = _moe_inputs(cfg, 8, 5)
    pp = jax.tree.map(_t, p)
    x = _t(np.random.default_rng(6).standard_normal(
        (R * B, 10, cfg.d_model)).astype(np.float32))
    ad = tree_map(_t, router_lora(cfg, (R,), 7))
    pacfg = port_acfg(ROUTER)
    kw = dict(capacity_factor=capacity, dispatch=dispatch)
    bank = make_bank_ctx(pc, pacfg, R)
    g = torch.from_numpy(_cotangent(tuple(x.shape)))
    y, aux, dx, dA, dB = _port_moe(pp, pc, x, ad, bank.for_layer, g, rows=R,
                                   **kw)
    assert aux.shape == (R,)
    solo = make_client_ctx(pc, pacfg)
    dropped = 0
    for r in range(R):
        rows = slice(r * B, (r + 1) * B)
        one = tree_map(lambda t: t[r], ad)
        y1, a1, dx1, dA1, dB1 = _port_moe(pp, pc, x[rows], one,
                                          solo.for_layer, g[rows], **kw)
        assert a1.shape == ()
        for got, want in ((y[rows], y1), (aux[r], a1), (dx[rows], dx1),
                          (dA[r], dA1), (dB[r], dB1)):
            assert torch.equal(got, want)
        if capacity is not None:
            _, idx, _ = port_moe._route(pp, pc, x[rows],
                                        solo.for_layer(one), "")
            cap = port_moe._capacity(B * 10, cfg.n_experts, cfg.top_k,
                                     capacity)
            dropped += int((~port_moe._slot_positions(
                idx, cfg.n_experts, cap)[1]).sum())
    assert (dropped > 0) == (capacity is not None)


def _packed(fn):
    """(result, storages of the non-0-d tensors autograd packed for the
    backward while ``fn`` ran)."""
    seen = {}

    def pack(t):
        if t.dim() > 0:
            seen[t.untyped_storage().data_ptr()] = t
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, seen


def test_recomputed_body_saves_only_its_inputs():
    """Under autograd the body runs under ``torch.utils.checkpoint``: the
    only tensor saved is the layer's input (the router LoRA's leaves ride
    the recompute), where the body alone saves its dispatch buffers and
    expert hiddens (and ``frozen_expert`` not the dispatch buffer it
    reads: only its weight); the grads are the body's bit for bit.
    Without differentiation (the serving path) the body runs alone and
    saves nothing."""
    cfg = tiny(MOE)
    pc = port_config(cfg)
    p, x = _moe_inputs(cfg, 40, 3)
    pp = jax.tree.map(_t, p)
    ctx = make_client_ctx(pc, port_acfg(ROUTER))
    ad = tree_map(lambda a: _t(a).requires_grad_(True), router_lora(cfg, (), 4))
    xin = _t(x).requires_grad_(True)
    lin = ctx.for_layer(ad)
    args = (pp, pc, xin, lin, "", 1.25, "scatter", True, 1)
    (y, aux), saved = _packed(lambda: port_moe.moe_forward(
        pp, pc, xin, lin, capacity_factor=1.25))
    assert [t.untyped_storage().data_ptr() for t in saved.values()] == \
        [xin.untyped_storage().data_ptr()]
    (yb, auxb), body = _packed(lambda: port_moe._body(*args))
    E = cfg.n_experts
    cap = port_moe._capacity(40, E, cfg.top_k, 1.25)
    weights = {t.untyped_storage().data_ptr() for t in tree_leaves(pp)}
    shapes = [tuple(t.shape) for ptr, t in body.items() if ptr not in weights]
    assert (E, cap, cfg.ffn_hidden) in shapes       # the expert hiddens
    assert (E, cap, cfg.d_model) not in shapes      # frozen_expert: weights only
    assert torch.equal(y, yb) and torch.equal(aux, auxb)
    leaves = [xin] + tree_leaves(ad)
    g = torch.ones_like(y)
    for a, b in zip(torch.autograd.grad((y * g).sum() + aux, leaves),
                    torch.autograd.grad((yb * g).sum() + auxb, leaves)):
        assert torch.equal(a, b)
    with torch.no_grad():
        (ys, auxs), none = _packed(lambda: port_moe.moe_forward(
            pp, pc, xin, lin, capacity_factor=1.25))
        assert none == {} and torch.equal(ys, y) and torch.equal(auxs, aux)
    (_, empty), _ = _packed(lambda: port_moe.moe_forward(
        pp, pc, xin.detach(), port_moe.blocks.DEFAULT_LIN, with_aux=False))
    assert empty is None


# ---------------------------------------------------------------------------
# the train makers against JAX's


def _row_grads_case(name, remat):
    cfg, pc, base = moe_system()
    bank, jbank = adapters(cfg, name, 1, 11)
    b = batches(cfg, 3, 1, (1,))[0]
    jacfg = JaxAdapterConfig(**ACFGS[name])
    jl, jg = jax.jit(jax_sym.make_row_grad_fn(cfg, jacfg, remat=False))(
        jax.tree.map(lambda a: jnp.asarray(a[0]), jbank),
        jax.tree.map(jnp.asarray, base),
        {k: jnp.asarray(v[0]) for k, v in b.items()})
    pl, pg = port_sym.make_row_grad_fn(pc, pcfg.AdapterConfig(**ACFGS[name]),
                                       remat=remat)(
        tree_map(lambda a: _t(a[0]), bank),
        convert.params_from_numpy(pc, base, "cpu"),
        {k: _t(v[0]) for k, v in b.items()})
    np.testing.assert_allclose(float(pl), float(jl), **TOL)
    got = jax_layout(cfg, tree_map(lambda t: t.numpy(), pg))
    assert jax.tree.structure(got) == jax.tree.structure(jg)
    for a, c in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(c), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["lora", pytest.param("ia3", marks=pytest.mark.tier2),
                                  pytest.param("prefix", marks=pytest.mark.tier2)])
def test_row_grad_fn_matches_reference(name):
    """One job's loss (with the MoE aux) and grads, drop-free; the port
    recomputes every layer and every MoE body (nested checkpoints)."""
    _row_grads_case(name, remat=True)


@pytest.mark.parametrize("name", ["lora", pytest.param("ia3", marks=pytest.mark.tier2)])
def test_baseline_train_step_matches_reference(name):
    """Two steps of the torch-like baseline (base linears hold their
    inputs) against JAX's ``make_baseline_train_step``."""
    cfg, pc, base = moe_system()
    bank, jbank = adapters(cfg, name, 1, 12)
    tc = dict(lr=1e-2, warmup_steps=1, total_steps=4, max_grad_norm=1.0,
              remat=False)
    jstep = jax.jit(jax_sym.make_baseline_train_step(
        cfg, JaxAdapterConfig(**ACFGS[name]), JaxTrainConfig(**tc)))
    pstep = port_sym.make_baseline_train_step(
        pc, pcfg.AdapterConfig(**ACFGS[name]), pcfg.TrainConfig(**tc))
    ja = jax.tree.map(lambda a: jnp.asarray(a[0]), jbank)
    jo = jax_adamw_init(ja)
    pa = tree_map(lambda a: _t(a[0]), bank)
    po = adamw_init(pa)
    pb = convert.params_from_numpy(pc, base, "cpu")
    for t, b in enumerate(batches(cfg, 4, 2, (1,))):
        ja, jo, jm = jstep(jax.tree.map(jnp.asarray, base), ja, jo,
                           {k: jnp.asarray(v[0]) for k, v in b.items()}, t)
        pa, po, pm = pstep(pb, pa, po, {k: _t(v[0]) for k, v in b.items()}, t)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), **TOL)
    assert_state_close(tuple(jax_layout(cfg, tree_map(np.asarray, t))
                             for t in (pa, po.m, po.v)), (ja, jo.m, jo.v))


CAP, R = 4, 3
SLOTS = np.array([2, 0, 3], np.int32)
MASK = np.array([True, True, False])


def _hyper(t):
    return {"step": np.array([t, t + 2, 0], np.int32),
            "lr": np.array([1e-2, 3e-3, 0.0], np.float32),
            "warmup": np.array([1, 0, 0], np.float32),
            "total": np.array([6, 4, 1], np.float32),
            "wd": np.array([0.0, 0.1, 0.0], np.float32),
            "gnorm": np.array([1.0, np.inf, np.inf], np.float32)}


@pytest.mark.parametrize("name", sorted(ACFGS))
def test_compact_train_step_matches_reference(name):
    """Two ticks of one bank (rows at slots 2 and 0 with their own
    schedules, one padding row) against JAX's ``vmap``ped step: losses,
    gnorms, and the bank and AdamW state after."""
    cfg, pc, base = moe_system()
    bank, jbank = adapters(cfg, name, CAP, 13)
    rng = np.random.default_rng(14)
    m = tree_map(lambda a: (rng.standard_normal(a.shape) * 0.01)
                 .astype(np.float32), bank)
    v = tree_map(lambda a: (rng.random(a.shape) * 1e-3).astype(np.float32),
                 bank)
    step = np.arange(CAP, dtype=np.int32) + 1
    jacfg = JaxAdapterConfig(**ACFGS[name])
    jfn = jax.jit(jax_sym.make_compact_train_step(cfg, jacfg, remat=False))
    jb = jax.tree.map(jnp.asarray, jbank)
    jo = JaxAdamWState(step=jnp.asarray(step),
                       m=jax.tree.map(jnp.asarray, jax_bank(cfg, m)),
                       v=jax.tree.map(jnp.asarray, jax_bank(cfg, v)))
    pfn = port_sym.make_compact_train_step(
        pc, pcfg.AdapterConfig(**ACFGS[name]), remat=False)
    pbk = tree_map(_t, bank)
    po = AdamWState(step=_t(step), m=tree_map(_t, m), v=tree_map(_t, v))
    pb = convert.params_from_numpy(pc, base, "cpu")
    for t, b in enumerate(batches(cfg, 15, 2, (R,))):
        jb, jo, jm = jfn(jax.tree.map(jnp.asarray, base), jb, jo,
                         jax.tree.map(jnp.asarray, b), jnp.asarray(SLOTS),
                         jnp.asarray(MASK), jax.tree.map(jnp.asarray,
                                                         _hyper(t)))
        pbk, po, pm = pfn(pb, pbk, po, tree_map(_t, b), _t(SLOTS), _t(MASK),
                          tree_map(_t, _hyper(t)))
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(pm[k].numpy()[MASK],
                                       np.asarray(jm[k])[MASK], **TOL)
    bank_np = lambda tr: convert._split_pre(tree_map(np.asarray, tr), 1,
                                            cfg.first_dense_layers)
    assert_state_close(tuple(bank_np(tr) for tr in (pbk, po.m, po.v)),
                       (jb, jo.m, jo.v))
    np.testing.assert_array_equal(po.step.numpy(), np.asarray(jo.step))


def test_bank_rows_equal_their_solo_runs_at_a_dropping_capacity():
    """The merged step's rows at ``capacity_factor=1.25`` against each
    row's one-row program, bit for bit: each row's capacity, drops and aux
    are its own, whoever trains beside it."""
    cfg, pc, base = moe_system()
    pacfg = pcfg.AdapterConfig(**ACFGS["lora"])
    bank, _ = adapters(cfg, "lora", R, 16)
    b = tree_map(_t, batches(cfg, 17, 1, (R,))[0])
    pb = convert.params_from_numpy(pc, base, "cpu")
    merged = port_sym._make_rows_grad_fn(
        pc, pacfg, remat=False, memory_optimized=True, microbatch=0,
        moe_dispatch="scatter", capacity_factor=1.25)
    solo = port_sym.make_row_grad_fn(pc, pacfg, remat=False,
                                     capacity_factor=1.25)
    losses, grads = merged(tree_map(_t, bank), pb, b)
    for r in range(R):
        l1, g1 = solo(tree_map(lambda a: _t(a[r]), bank), pb,
                      {k: v[r] for k, v in b.items()})
        assert torch.equal(losses[r], l1)
        for a, c in zip(tree_leaves(grads), tree_leaves(g1)):
            assert torch.equal(a[r], c)


def test_multi_client_train_step_matches_reference():
    """C = 3 clients on one schedule at JAX's default capacity factor
    (1.25: tokens drop), two steps."""
    cfg, pc, base = moe_system()
    bank, jbank = adapters(cfg, "lora", R, 18)
    tc = dict(lr=1e-2, warmup_steps=1, total_steps=4, max_grad_norm=1.0,
              remat=False)
    jacfg = JaxAdapterConfig(**ACFGS["lora"])
    jfn = jax.jit(jax_sym.make_multi_client_train_step(
        cfg, jacfg, JaxTrainConfig(**tc)))
    pfn = port_sym.make_multi_client_train_step(
        pc, pcfg.AdapterConfig(**ACFGS["lora"]), pcfg.TrainConfig(**tc))
    jb = jax.tree.map(jnp.asarray, jbank)
    jo = jax.vmap(jax_adamw_init)(jb)
    pbk = tree_map(_t, bank)
    po = AdamWState(step=torch.zeros(R, dtype=torch.int32),
                    m=tree_map(torch.zeros_like, pbk),
                    v=tree_map(torch.zeros_like, pbk))
    pb = convert.params_from_numpy(pc, base, "cpu")
    for t, b in enumerate(batches(cfg, 19, 2, (R,))):
        jb, jo, jm = jfn(jax.tree.map(jnp.asarray, base), jb, jo,
                         jax.tree.map(jnp.asarray, b), t)
        pbk, po, pm = pfn(pb, pbk, po, tree_map(_t, b), t)
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]),
                                       **TOL)
    bank_np = lambda tr: convert._split_pre(tree_map(np.asarray, tr), 1,
                                            cfg.first_dense_layers)
    assert_state_close(tuple(bank_np(tr) for tr in (pbk, po.m, po.v)),
                       (jb, jo.m, jo.v))


# ---------------------------------------------------------------------------
# the engines


class MoePair(Pair):
    """``Pair`` over the MoE base: adapters drawn in the port's layout
    (LoRA A and B non-zero, the router's too) and handed to JAX in its
    own."""
    system = staticmethod(moe_system)

    def numpy_adapter(self, ja, seed):
        return tree_map(lambda a: a[0],
                        numpy_bank(self.cfg, ja, 1, 100 + seed))

    def jax_layout(self, tree):
        return jax_layout(self.cfg, tree)


def test_finetune_engine_matches_reference():
    """LoRA (q, v, router) jobs behind a router that holds the third back
    until the second retires, tick by tick against the JAX engine (both
    drop-free, as the engine runs); JAX's charge exactly, the port's by
    its activation term."""
    from repro.training import job_hbm_bytes as jax_job_hbm_bytes
    from repro_torch.training import job_charge_bytes, job_hbm_bytes
    cfg, pc, _ = moe_system()
    jj, pj = MoePair().make(0, steps=2, acfg=ACFGS["lora"])
    nbytes = job_hbm_bytes(pc, pj)
    assert nbytes == jax_job_hbm_bytes(cfg, jj)
    charge = job_charge_bytes(pc, pj)
    p = MoePair(slot_bytes=nbytes * 2.5, port_slot_bytes=charge * 2.5)
    p.submit(0, steps=4, acfg=ACFGS["lora"])
    p.submit(1, steps=2, acfg=ACFGS["lora"])
    p.submit(2, steps=2, acfg=ACFGS["lora"])       # waits for a slot
    p.tick()
    assert p.port.n_active == 2 and len(p.port._queue) == 1
    p.run()
    assert p.port.stats["train_steps"] == 8


def _serve_parts():
    cfg, pc, base = moe_system()
    pb = convert.params_from_numpy(pc, base, "cpu")
    pacfg = pcfg.AdapterConfig(**ACFGS["lora"])
    bank = convert.bank_from_numpy(pacfg, numpy_bank(
        cfg, JaxAdapterConfig(**ACFGS["lora"]), 2, 31), "cpu")
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, 2),),
                      serve=pcfg.ServeConfig(n_clients=2, max_seq=32,
                                             page_block=8),
                      finetune=pcfg.FinetuneConfig(),
                      max_batch_per_client=2)
    return pc, pb, bank, pacfg, spec


def _requests(pc):
    rng = np.random.default_rng(5)
    return [Request(client_id=i % 2,
                    prompt=rng.integers(0, pc.vocab, (1, 6)).astype(np.int32),
                    max_new_tokens=6, arrive_tick=i) for i in range(3)]


def _jobs(pc, pacfg):
    return [FinetuneJob(acfg=pacfg, batch_size=2, seq_len=S, steps=s,
                        data=make_job_stream(pc, 2, S, seed=i, device="cpu"),
                        seed=i, lr=1e-2, warmup_steps=1)
            for i, s in enumerate((3, 2))]


def test_symbiosis_engine_serves_beside_moe_jobs():
    """Router-targeted LoRA tenants served on pages beside two MoE jobs on
    ONE base: every stream equals serving alone and every job its
    ``FinetuneEngine`` run alone, bit for bit."""
    pc, pb, bank, pacfg, spec = _serve_parts()
    sym = SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                    device="cpu")
    reqs, jobs = _requests(pc), _jobs(pc, pacfg)
    for item in reqs + jobs:
        sym.submit(item)
    done_r, done_j = sym.run()
    assert len(done_r) == 3 and len(done_j) == 2
    serv = ServingEngine(spec, pb, [bank], device="cpu")
    alone = _requests(pc)
    for r in alone:
        serv.submit(r)
    serv.run()
    for a, b in zip(reqs, alone):
        np.testing.assert_array_equal(a.generated, b.generated)
    ft = FinetuneEngine(spec, pb, device="cpu")
    solo = _jobs(pc, pacfg)
    for j in solo:
        ft.submit(j)
    ft.run()
    for a, b in zip(jobs, solo):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)


def test_job_checkpoint_crosses_both_ways():
    """An MoE job's adapter (the router leaf too) and AdamW state written
    by either package restore in the other: the port writes JAX's layout
    (the dense first layer as ``pre_layers``), the same manifest."""
    import json
    import os
    import tempfile
    cfg, pc, _ = moe_system()
    bank, jbank = adapters(cfg, "lora", 1, 40)
    rng = np.random.default_rng(41)
    mom = tree_map(lambda a: rng.standard_normal(a.shape)
                   .astype(np.float32), bank)
    pad = tree_map(lambda a: _t(a[0]), bank)
    popt = AdamWState(step=torch.tensor(5, dtype=torch.int32),
                      m=tree_map(lambda a: _t(a[0]), mom),
                      v=tree_map(lambda a: _t(np.abs(a[0])), mom))
    jad = jax.tree.map(lambda a: jnp.asarray(a[0]), jbank)
    jmom = jax_bank(cfg, mom)
    jopt = JaxAdamWState(step=jnp.asarray(5, jnp.int32),
                         m=jax.tree.map(lambda a: jnp.asarray(a[0]), jmom),
                         v=jax.tree.map(lambda a: jnp.abs(jnp.asarray(a[0])),
                                        jmom))
    with tempfile.TemporaryDirectory() as d:
        jpath = jax_ckpt.save_job_state(os.path.join(d, "j"), 5, jad, jopt,
                                        name="t")
        ppath = save_job_state(os.path.join(d, "p"), 5, pad, popt, name="t",
                               cfg=pc)
        with open(os.path.join(jpath, "manifest.json")) as f:
            jm = json.load(f)
        with open(os.path.join(ppath, "manifest.json")) as f:
            assert json.load(f) == jm
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


# ---------------------------------------------------------------------------
# the activation term of the fine-tuning charge


def _saved_bytes(cfg, acfg, memory_optimized, batch=None):
    """Bytes of the distinct storages autograd packs for the backward of
    one job's step (``saved_tensors_hooks``: a recomputed MoE body shows
    as its input only), the base and adapter leaves (resident, charged
    elsewhere) and 0-d scalars left out."""
    from repro_torch.core import adapters as port_adapters
    from repro_torch.models import get_model
    from repro_torch.models.losses import lm_loss
    g = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_params(g, "cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not memory_optimized),
                    base)
    params = tree_map(lambda x: x.detach().requires_grad_(True),
                      port_adapters.init_adapter(cfg, acfg, g, device="cpu"))
    batch = batch or {}
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    skip = {t.untyped_storage().data_ptr()
            for t in tree_leaves(base) + tree_leaves(params)
            + list(batch.values())}
    ctx = make_client_ctx(cfg, acfg, memory_optimized=memory_optimized)
    with torch.enable_grad():
        (logits, aux), seen = _packed(lambda: get_model(cfg).forward(
            base, dict(batch, tokens=toks), ctx, params, remat=False,
            with_aux=True))
        _, more = _packed(lambda: lm_loss(logits, toks, None, aux))
    seen.update(more)
    return sum(t.untyped_storage().nbytes() for p, t in seen.items()
               if p not in skip)


ACT_ACFGS = {
    "lora": pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0,
                               targets=("q", "v", "router")),
    "lora_all": pcfg.AdapterConfig(method="lora", rank=8, alpha=8.0,
                                   targets=("q", "k", "v", "o", "gate",
                                            "up", "down", "router")),
    "ia3": pcfg.AdapterConfig(method="ia3", targets=("k", "v", "down")),
    "prefix": pcfg.AdapterConfig(method="prefix", targets=("q", "v"),
                                 n_prefix=4),
}


def act_config(dtype, **kw):
    base = dict(name="t", arch="moe", n_layers=3, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=96, vocab=200, head_dim=16, dtype=dtype,
                param_dtype=dtype, n_experts=4, top_k=2, n_shared_experts=1,
                d_expert=32, first_dense_layers=1)
    base.update(kw)
    return pcfg.ModelConfig(**base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method,mem_opt,residual", [
    ("lora", True, False), ("lora_all", False, False), ("ia3", True, False),
    ("prefix", False, False), ("lora_all", True, True)])
def test_activation_term_counts_moe_layers(dtype, method, mem_opt, residual):
    """``job_activation_bytes`` of an MoE model, the check of
    ``test_torch_faults.test_activation_term_counts_the_saved_tensors``
    carried to its layer kinds: an MoE layer (2 -> 3 layers) and a first
    dense layer in its place (1 -> 2 dense layers) each add exactly what
    autograd saves; one MoE body's recomputed tensors are
    ``_moe_body_saved_bytes`` exactly (the body run alone); the charge
    stays above the step's saved tensors. ``residual``: Arctic's dense
    FFN beside the MoE."""
    from repro_torch.training import job_activation_bytes
    from repro_torch.training.engine import _moe_body_saved_bytes
    acfg = ACT_ACFGS[method]
    job = FinetuneJob(acfg=acfg, data=None, batch_size=2, seq_len=24,
                      steps=1)
    kw = dict(dense_residual=True) if residual else {}
    cfgs = {(L, pre): act_config(dtype, n_layers=L, first_dense_layers=pre,
                                 **kw) for L, pre in ((2, 1), (3, 1), (3, 2))}
    got = {k: _saved_bytes(c, acfg, mem_opt) for k, c in cfgs.items()}
    want = {k: job_activation_bytes(c, job, memory_optimized=mem_opt)
            for k, c in cfgs.items()}
    for a, b in (((3, 1), (2, 1)), ((3, 2), (3, 1))):
        assert got[a] - got[b] == want[a] - want[b]
    assert all(want[k] >= got[k] for k in cfgs)
    cfg = cfgs[(2, 1)]
    g = torch.Generator().manual_seed(1)
    from repro_torch.core import adapters as port_adapters
    from repro_torch.models import get_model
    base = get_model(cfg).init_params(g, "cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not mem_opt), base)
    ad = tree_map(lambda x: x.detach().requires_grad_(True),
                  port_adapters.init_adapter(cfg, acfg, g, device="cpu"))
    lin = make_client_ctx(cfg, acfg, memory_optimized=mem_opt).for_layer(
        tree_map(lambda t: t[1], ad["layers"]))
    x = torch.randn((2, 24, cfg.d_model), generator=g) \
        .to(getattr(torch, dtype)).requires_grad_(True)
    skip = {t.untyped_storage().data_ptr()
            for t in tree_leaves(base) + tree_leaves(ad) + [x]}
    with torch.enable_grad():
        _, body = _packed(lambda: port_moe._body(
            base["layers"][1]["moe"], cfg, x, lin, "", None, "scatter", True,
            1))
    assert sum(t.untyped_storage().nbytes() for p, t in body.items()
               if p not in skip) == \
        _moe_body_saved_bytes(cfg, acfg, 2, 24, mem_opt)
