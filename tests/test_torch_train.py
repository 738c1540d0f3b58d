"""PyTorch port vs the JAX reference: the fine-tuning path — ``lm_loss``,
the training ``forward``, ``make_baseline_train_step`` and
``make_compact_train_step`` — and the synthetic data pipeline.

Both packages take the same numpy-made base, LoRA adapters (A and B
non-zero) and batches on a tiny fp32 dense config. Logits and losses are
held at atol = rtol = 1e-5, adapters and AdamW moments after three steps
at rtol 1e-4 with an atol of 1e-3 of each leaf's largest magnitude, at most
1e-4 (three optimizer steps amplify the fp32 rounding of two frameworks
summing in different orders; Adam's first step moves each weight by ~lr
whatever the gradient's size; the scaled atol holds a second moment of
~1e-6 to its own scale). Within the port the compact step's
bookkeeping is held bit for bit: slots outside the call, padding rows and
non-finite rows keep their state, and a NaN row leaves every other row
exactly as the unpoisoned run leaves it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.core import symbiosis as jax_sym
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import get_model as jax_get_model
from repro.models.losses import lm_loss as jax_lm_loss
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import get_model
from repro_torch.models.losses import lm_loss
from repro_torch.optim import AdamWState, adamw_init
from conftest import tiny
from test_torch_model import numpy_base, port_config
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
ACFG = JaxAdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
PACFG = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
B, S = 2, 16


def numpy_adapter(cfg, seed, lead=(), acfg=ACFG):
    """One job's LoRA tree (A and B non-zero), or R of them with
    ``lead=(R,)``."""
    rng = np.random.default_rng(seed)
    L, r, d, hd = cfg.n_layers, acfg.rank, cfg.d_model, cfg.hd
    dims = {"q": (d, cfg.hp * hd), "k": (d, cfg.n_kv_heads * hd),
            "v": (d, cfg.n_kv_heads * hd), "o": (cfg.hp * hd, d)}
    return {"layers": {t: {
        "A": (rng.standard_normal(lead + (L, din, r)) / np.sqrt(din))
        .astype(np.float32),
        "B": (rng.standard_normal(lead + (L, r, dout)) * 0.1)
        .astype(np.float32)} for t, (din, dout) in dims.items()
        if t in acfg.targets}}


def batches(cfg, seed, n, lead=()):
    """``n`` steps of numpy batches [*lead, B, S] from the JAX pipeline."""
    R = int(np.prod(lead)) if lead else 1
    ds = JaxDataset(vocab=cfg.vocab, seq_len=S, n_clients=R,
                    batch_per_client=B, seed=seed)
    out = []
    for t in range(n):
        b = {k: np.array(v) for k, v in ds.batch(t).items()}
        out.append({k: v if lead else v[0] for k, v in b.items()})
    return out


@functools.lru_cache(maxsize=None)
def system():
    cfg = tiny()
    return cfg, port_config(cfg), numpy_base(cfg, 21)


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def port_tree(tree):
    return tree_map(torch.from_numpy, tree)


def port_base(pc, base):
    return convert.params_from_numpy(pc, base, "cpu")


def assert_state_close(got, want):
    """Adapter and AdamW trees leaf by leaf, each at rtol 1e-4 and an atol
    scaled to the leaf (1e-3 of its largest magnitude, at most 1e-4): a
    second moment of ~1e-6 is held to its own scale, not to 1e-4."""
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        atol = min(1e-4, 1e-3 * float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask,prefix", [(False, 0), (True, 0), (True, 3)])
def test_lm_loss_matches_reference(mask, prefix):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9 + prefix, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 9)).astype(np.int32)
    m = (rng.random((2, 9)) > 0.3).astype(np.float32) if mask else None
    want = float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                             None if m is None else jnp.asarray(m)))
    got = float(lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if m is None else torch.from_numpy(m)))
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_matches_reference_and_remat_changes_nothing():
    cfg, pc, base = system()
    ad = numpy_adapter(cfg, 2)
    tokens = batches(cfg, 3, 1)[0]["tokens"]
    jctx = jax_sym.make_client_ctx(cfg, ACFG)
    want, _ = jax_get_model(cfg).forward(jax_tree(base), {"tokens": tokens},
                                         jctx, jax_tree(ad), remat=False)
    model, ctx = get_model(pc), make_client_ctx(pc, PACFG)
    pb, pa = port_base(pc, base), port_tree(ad)
    got = {remat: model.forward(pb, {"tokens": torch.from_numpy(tokens)},
                                ctx, pa, remat=remat) for remat in (False, True)}
    np.testing.assert_allclose(got[False].numpy(), np.asarray(want), **TOL)
    assert torch.equal(got[True], got[False])
    # and the grads through the recomputed layers are the same
    fn = {remat: port_sym.make_row_grad_fn(pc, PACFG, remat=remat)
          for remat in (False, True)}
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 3, 1)[0].items()}
    (l0, g0), (l1, g1) = (fn[r](pa, pb, b) for r in (False, True))
    assert torch.equal(l0, l1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6, rtol=1e-6)


TCFGS = {   # (TrainConfig fields) — the microbatched job accumulates 2 x 2
    "plain": dict(lr=1e-2, warmup_steps=1, total_steps=6, max_grad_norm=1.0,
                  weight_decay=0.0),
    "decay_no_clip": dict(lr=3e-3, warmup_steps=0, total_steps=3,
                          max_grad_norm=0.0, weight_decay=0.1),
    "microbatched": dict(lr=1e-2, warmup_steps=2, total_steps=5,
                         max_grad_norm=0.5, weight_decay=0.0, microbatch=2),
}


@pytest.mark.parametrize("name", sorted(TCFGS))
def test_baseline_train_step_matches_reference(name):
    """Three steps of the dedicated trainer: loss, gnorm, lr each step, and
    the adapter and both moment trees after, against JAX's."""
    cfg, pc, base = system()
    kw = dict(TCFGS[name], remat=False)
    batch_n = 2 * B if kw.get("microbatch") else B
    ad = numpy_adapter(cfg, 4)
    rng_batches = []
    for t, b in enumerate(batches(cfg, 5, 3)):
        if batch_n != B:       # two halves of two steps make one batch of 4
            b2 = batches(cfg, 50 + t, 1)[0]
            b = {k: np.concatenate([b[k], b2[k]]) for k in b}
        rng_batches.append(b)
    jstep = jax.jit(jax_sym.make_baseline_train_step(cfg, ACFG,
                                                     JaxTrainConfig(**kw)))
    pstep = port_sym.make_baseline_train_step(pc, PACFG, pcfg.TrainConfig(**kw))
    ja, jo = jax_tree(ad), jax_adamw_init(jax_tree(ad))
    pa = port_tree(ad)
    po = adamw_init(pa)
    pb = port_base(pc, base)
    for t, b in enumerate(rng_batches):
        ja, jo, jm = jstep(jax_tree(base), ja, jo, jax_tree(b), t)
        pa, po, pm = pstep(pb, pa, po, port_tree(b), t)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), **TOL)
    assert_state_close((pa, po.m, po.v), (ja, jo.m, jo.v))
    assert int(po.step) == int(jo.step) == 3


# ---------------------------------------------------------------------------
# the compact multi-job step

CAP, R = 6, 4
SLOTS = np.array([4, 1, 3, 0], np.int32)       # padding row aliases slot 0
MASK = np.array([True, True, True, False])


def hyper_rows(t):
    return {"step": np.array([t, t + 2, t + 5, 0], np.int32),
            "lr": np.array([1e-2, 3e-3, 5e-3, 0.0], np.float32),
            "warmup": np.array([1, 0, 3, 0], np.float32),
            "total": np.array([6, 4, 20, 1], np.float32),
            "wd": np.array([0.0, 0.1, 0.0, 0.0], np.float32),
            "gnorm": np.array([1.0, np.inf, 0.3, np.inf], np.float32)}


def bank_state(cfg):
    """A bank of CAP slots, every slot non-zero (so a stray write shows),
    the rows at random AdamW positions."""
    bank = numpy_adapter(cfg, 6, (CAP,))
    rng = np.random.default_rng(7)
    m = tree_map(lambda a: (rng.standard_normal(a.shape) * 0.01)
                 .astype(np.float32), bank)
    v = tree_map(lambda a: (rng.random(a.shape) * 1e-3).astype(np.float32),
                 bank)
    return bank, np.arange(CAP, dtype=np.int32) + 1, m, v


def port_bank(cfg):
    bank, step, m, v = bank_state(cfg)
    return port_tree(bank), AdamWState(step=torch.from_numpy(step),
                                       m=port_tree(m), v=port_tree(v))


def run_port_compact(pc, pb, bank, opt, steps, mutate=None, microbatch=0):
    fn = port_sym.make_compact_train_step(pc, PACFG, remat=False,
                                          microbatch=microbatch)
    out = []
    for t, b in enumerate(steps):
        b = port_tree(b)
        if mutate is not None:
            mutate(t, b)
        bank, opt, m = fn(pb, bank, opt, b, torch.from_numpy(SLOTS),
                          torch.from_numpy(MASK),
                          port_tree(hyper_rows(t)))
        out.append(m)
    return bank, opt, out


def test_compact_train_step_matches_reference():
    """Three ticks of one bank (rows at slots 4, 1, 3 with their own
    schedules, decay and clipping; one padding row) against the JAX step."""
    cfg, pc, base = system()
    steps = batches(cfg, 8, 3, (R,))
    bank, step, m, v = bank_state(cfg)
    jfn = jax.jit(jax_sym.make_compact_train_step(cfg, ACFG, remat=False))
    jb = jax_tree(bank)
    from repro.optim.adamw import AdamWState as JaxAdamWState
    jo = JaxAdamWState(step=jnp.asarray(step), m=jax_tree(m), v=jax_tree(v))
    jms = []
    for t, b in enumerate(steps):
        jb, jo, jm = jfn(jax_tree(base), jb, jo, jax_tree(b),
                         jnp.asarray(SLOTS), jnp.asarray(MASK),
                         jax_tree(hyper_rows(t)))
        jms.append(jm)
    pbank, popt = port_bank(cfg)
    pbank, popt, pms = run_port_compact(pc, port_base(pc, base), pbank, popt,
                                        steps)
    for pm, jm in zip(pms, jms):
        live = MASK
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(pm[k].numpy()[live],
                                       np.asarray(jm[k])[live], **TOL)
        assert pm["finite"].numpy()[live].all()
    assert_state_close((pbank, popt.m, popt.v), (jb, jo.m, jo.v))
    np.testing.assert_array_equal(popt.step.numpy(), np.asarray(jo.step))


@pytest.mark.parametrize("microbatch", [0, 2])
def test_compact_rows_match_their_solo_steps(microbatch):
    """Each live row of the merged step against that job's own baseline
    step in the port (the merged forward sums the base products over all
    rows' tokens, so the match is to rounding, not bit for bit)."""
    cfg, pc, base = system()
    Bn = 2 * B if microbatch else B
    steps = batches(cfg, 9, 3, (R,))
    if microbatch:
        more = batches(cfg, 90, 3, (R,))
        steps = [{k: np.concatenate([a[k], c[k]], axis=1) for k in a}
                 for a, c in zip(steps, more)]
    assert steps[0]["tokens"].shape == (R, Bn, S)
    pb = port_base(pc, base)
    bank, opt = port_bank(cfg)
    solo = [(tree_map(lambda x: x[s].clone(), bank),
             AdamWState(step=opt.step[s].clone(),
                        m=tree_map(lambda x: x[s].clone(), opt.m),
                        v=tree_map(lambda x: x[s].clone(), opt.v)))
            for s in SLOTS]
    bank, opt, ms = run_port_compact(pc, pb, bank, opt, steps,
                                     microbatch=microbatch)
    for i in np.flatnonzero(MASK):
        h = {k: v[i] for k, v in hyper_rows(0).items()}
        tcfg = pcfg.TrainConfig(
            lr=float(h["lr"]), warmup_steps=int(h["warmup"]),
            total_steps=int(h["total"]), weight_decay=float(h["wd"]),
            max_grad_norm=0.0 if np.isinf(h["gnorm"]) else float(h["gnorm"]),
            remat=False, microbatch=microbatch)
        fn = port_sym.make_baseline_train_step(pc, PACFG, tcfg,
                                               memory_optimized=True)
        a, o = solo[i]
        for t, b in enumerate(steps):
            a, o, m = fn(pb, a, o, {k: torch.from_numpy(v[i])
                                    for k, v in b.items()},
                         int(hyper_rows(t)["step"][i]))
            np.testing.assert_allclose(float(ms[t]["loss"][i]),
                                       float(m["loss"]), **TOL)
        s = int(SLOTS[i])
        assert_state_close(tree_map(lambda x: x[s], (bank, opt.m, opt.v)),
                           tree_map(np.asarray, (a, o.m, o.v)))


def test_compact_step_bit_exact_bookkeeping():
    """In the port, bit for bit: slots outside the call (2, 5) and the
    padding row's slot keep their state; a row poisoned with a NaN mask
    commits nothing (its slot keeps its last clean state) and is reported
    non-finite; every other row equals the unpoisoned run exactly."""
    cfg, pc, base = system()
    pb = port_base(pc, base)
    steps = batches(cfg, 10, 2, (R,))
    clean_bank, clean_opt, _ = run_port_compact(pc, pb, *port_bank(cfg),
                                                steps)
    start_bank, start_opt = port_bank(cfg)

    def poison(t, b):
        if t == 1:
            b["mask"] = torch.ones(b["labels"].shape)
            b["mask"][1] = float("nan")       # the row at slot 1

    bank, opt = port_bank(cfg)
    bank, opt, ms = run_port_compact(pc, pb, bank, opt, steps, poison)
    assert ms[0]["finite"].all() and not bool(ms[1]["finite"][1])
    assert ms[1]["finite"][[0, 2]].all()
    after_one = run_port_compact(pc, pb, *port_bank(cfg), steps[:1])
    for full, clean, start, one in zip(
            tree_leaves((bank, opt)), tree_leaves((clean_bank, clean_opt)),
            tree_leaves((start_bank, start_opt)),
            tree_leaves(after_one[:2])):
        for s in (2, 5):                       # never in the call
            assert torch.equal(full[s], start[s])
        for s in (4, 3):                       # survivors: the clean run's
            assert torch.equal(full[s], clean[s])
        assert torch.equal(full[1], one[1])    # slot 1: its step-0 state
        assert torch.equal(full[0], start[0])  # padding row's slot


def test_all_rows_dropped_writes_nothing():
    """A call in which no row commits leaves the whole bank bit for bit."""
    cfg, pc, base = system()
    bank, opt = port_bank(cfg)
    before = [t.clone() for t in tree_leaves((bank, opt))]
    fn = port_sym.make_compact_train_step(pc, PACFG, remat=False)
    b = port_tree(batches(cfg, 11, 1, (R,))[0])
    bank, opt, m = fn(port_base(pc, base), bank, opt, b,
                      torch.from_numpy(SLOTS), torch.zeros(R, dtype=torch.bool),
                      port_tree(hyper_rows(0)))
    for a, c in zip(tree_leaves((bank, opt)), before):
        assert torch.equal(a, c)


def test_synthetic_dataset_matches_reference():
    for seed, C in ((0, 1), (3, 4)):
        want = JaxDataset(vocab=97, seq_len=12, n_clients=C,
                          batch_per_client=3, seed=seed)
        got = SyntheticLMDataset(vocab=97, seq_len=12, n_clients=C,
                                 batch_per_client=3, seed=seed, device="cpu")
        for t in (0, 1, 7):
            w, g = want.batch(t), got.batch(t)
            for k in ("tokens", "labels"):
                assert g[k].dtype == torch.int32
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
