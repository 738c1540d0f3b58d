"""PyTorch port vs the JAX reference: the VLM family fine-tunes on the
shared base, on the CPU.

Checked on ``tiny(VLM)`` (8 stubbed image tokens before the text), fp32,
with the base drawn by numpy (``test_torch_moe.numpy_params``) and JAX's
own ``frontend_stub`` draw handed to both packages (the port draws its
stand-in itself; the tokens of both pipelines are the same numpy draw):

* ``lm_loss`` strips the image prefix and adds each row's aux, against
  JAX's, row by row;
* the merged bank step with ``img_embed`` [R, B, Ti, d] flattened beside
  the tokens: the compact step's losses and states against JAX's ``vmap``
  (atol = rtol = 1e-5; states as ``test_torch_train.assert_state_close``),
  and each row against its one-row run, bit for bit in the port;
* ``make_client_batches`` / ``make_job_stream`` carry the image prefix;
* the ``FinetuneEngine`` against JAX's tick by tick;
* the activation charge counts the prefix: each layer adds what autograd
  saves over ``n_frontend_tokens + seq_len`` positions; the working-set
  term counts the batch the job's stream hands out, image prefix too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import VLM
from repro.core import symbiosis as jax_sym
from repro.data.pipeline import frontend_stub as jax_frontend_stub
from repro.data.pipeline import make_client_batches as jax_client_batches
from repro.models.losses import lm_loss as jax_lm_loss
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import symbiosis as port_sym
from repro_torch.data import make_client_batches
from repro_torch.models.losses import lm_loss
from repro_torch.optim import AdamWState
from repro_torch.training import FinetuneJob, job_activation_bytes
from conftest import tiny
from test_torch_finetune_engine import Pair
from test_torch_model import port_config
from test_torch_moe import numpy_bank, numpy_params
from test_torch_moe_train import _saved_bytes
from test_torch_train import assert_state_close

TOL = dict(atol=1e-5, rtol=1e-5)
LORA = dict(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
B, S, R = 2, 10, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def vlm_system():
    cfg = tiny(VLM)
    return cfg, port_config(cfg), numpy_params(cfg, 21)


def vlm_batch(cfg, seed, lead):
    """One step's numpy batch [*lead, B, ...] from JAX's pipeline, its
    ``img_embed`` JAX's frontend draw."""
    n = int(np.prod(lead))
    b = jax_client_batches(cfg, n, B, S, seed=seed).batch(0)
    return {k: np.array(v).reshape(lead + v.shape[1:]) for k, v in b.items()}


def test_lm_loss_strips_the_prefix_and_adds_each_rows_aux():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((R, B, 8 + S, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (R, B, S)).astype(np.int32)
    mask = (rng.random((R, B, S)) > 0.3).astype(np.float32)
    aux = rng.random(R).astype(np.float32)
    for r in range(R):
        want = float(jax_lm_loss(jnp.asarray(logits[r]),
                                 jnp.asarray(labels[r]),
                                 jnp.asarray(mask[r]), jnp.asarray(aux[r])))
        got = float(lm_loss(_t(logits[r]), _t(labels[r]), _t(mask[r]),
                            _t(aux)[r]))
        np.testing.assert_allclose(got, want, **TOL)


def test_batches_carry_the_image_prefix():
    """The port's streams hand out JAX's tokens and an ``img_embed`` of
    JAX's shape, the same at every step and on every call."""
    cfg = tiny(VLM)
    pc = port_config(cfg)
    got = make_client_batches(pc, 2, B, S, seed=3, device="cpu")
    want = jax_client_batches(cfg, 2, B, S, seed=3)
    for step in (0, 1):
        g, w = got.batch(step), want.batch(step)
        assert sorted(g) == sorted(w) == ["img_embed", "labels", "tokens"]
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
        assert tuple(g["img_embed"].shape) == tuple(w["img_embed"].shape)
    assert torch.equal(got.batch(0)["img_embed"],
                       make_client_batches(pc, 2, B, S, seed=3,
                                           device="cpu").batch(5)["img_embed"])


CAP = 4
SLOTS = np.array([3, 1, 0], np.int32)
MASK = np.array([True, True, False])


def _hyper():
    return {"step": np.array([0, 2, 0], np.int32),
            "lr": np.array([1e-2, 3e-3, 0.0], np.float32),
            "warmup": np.array([1, 0, 0], np.float32),
            "total": np.array([6, 4, 1], np.float32),
            "wd": np.array([0.0, 0.1, 0.0], np.float32),
            "gnorm": np.array([1.0, np.inf, np.inf], np.float32)}


def test_compact_train_step_with_the_image_prefix():
    """One tick of a VLM bank (two jobs, one padding row), ``img_embed``
    in the batch: losses and the state after against JAX's; each live
    row's loss and grads against its one-row run, bit for bit."""
    cfg, pc, base = vlm_system()
    bank = numpy_bank(cfg, JaxAdapterConfig(**LORA), CAP, 5)
    b = vlm_batch(cfg, 6, (R,))
    assert b["img_embed"].shape == (R, B, cfg.n_frontend_tokens,
                                    cfg.d_model)
    step = np.arange(CAP, dtype=np.int32)
    zeros = tree_map(np.zeros_like, bank)
    jfn = jax.jit(jax_sym.make_compact_train_step(
        cfg, JaxAdapterConfig(**LORA), remat=False))
    jb, jo, jm = jfn(jax.tree.map(jnp.asarray, base),
                     jax.tree.map(jnp.asarray, bank),
                     JaxAdamWState(step=jnp.asarray(step),
                                   m=jax.tree.map(jnp.asarray, zeros),
                                   v=jax.tree.map(jnp.asarray, zeros)),
                     jax.tree.map(jnp.asarray, b), jnp.asarray(SLOTS),
                     jnp.asarray(MASK), jax.tree.map(jnp.asarray, _hyper()))
    pacfg = pcfg.AdapterConfig(**LORA)
    pb = convert.params_from_numpy(pc, base, "cpu")
    pbk, po, pm = port_sym.make_compact_train_step(pc, pacfg, remat=False)(
        pb, tree_map(_t, bank),
        AdamWState(step=_t(step), m=tree_map(_t, zeros),
                   v=tree_map(_t, zeros)),
        tree_map(_t, b), _t(SLOTS), _t(MASK), tree_map(_t, _hyper()))
    for k in ("loss", "gnorm"):
        np.testing.assert_allclose(pm[k].numpy()[MASK],
                                   np.asarray(jm[k])[MASK], **TOL)
    assert_state_close((pbk, po.m, po.v), (jb, jo.m, jo.v))
    merged = port_sym._make_rows_grad_fn(
        pc, pacfg, remat=False, memory_optimized=True, microbatch=0,
        moe_dispatch="scatter", capacity_factor=None)
    solo = port_sym.make_row_grad_fn(pc, pacfg, remat=False)
    rows = tree_map(lambda a: _t(a[SLOTS]), bank)
    losses, grads = merged(rows, pb, tree_map(_t, b))
    for r in range(R):
        l1, g1 = solo(tree_map(lambda t: t[r], rows), pb,
                      {k: _t(v[r]) for k, v in b.items()})
        assert torch.equal(losses[r], l1)
        for a, c in zip(tree_leaves(grads), tree_leaves(g1)):
            assert torch.equal(a[r], c)


class VlmPair(Pair):
    """``Pair`` over the VLM base; each port job's stream hands out JAX's
    image draw (the tokens are already the same)."""
    system = staticmethod(vlm_system)

    def port_stream(self, stream, seed):
        img = jax_frontend_stub(self.cfg, 1, stream._stream.ds.batch_per_client,
                                seed=seed)["img_embed"]
        stream._stream.extra["img_embed"] = _t(img)
        return stream


def test_finetune_engine_matches_reference():
    p = VlmPair()
    p.submit(0, steps=3)
    p.submit(1, steps=2)
    p.run()
    assert p.port.stats["train_steps"] == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["lora", "prefix"])
def test_activation_term_counts_the_image_prefix(dtype, method):
    """Each VLM layer adds exactly what ``job_activation_bytes`` adds per
    layer (2 -> 3 layers) over Ti + S positions, and the charge stays
    above the step's saved tensors."""
    acfg = (pcfg.AdapterConfig(**LORA) if method == "lora" else
            pcfg.AdapterConfig(method="prefix", targets=("q", "v"),
                               n_prefix=4))
    job = FinetuneJob(acfg=acfg, data=None, batch_size=2, seq_len=24,
                      steps=1)
    got, want = [], []
    for L in (2, 3):
        cfg = pcfg.ModelConfig(name="t", arch="vlm", n_layers=L, d_model=64,
                               n_heads=4, n_kv_heads=2, d_ff=96, vocab=200,
                               head_dim=16, dtype=dtype, param_dtype=dtype,
                               n_frontend_tokens=8)
        img = torch.randn((2, 8, 64), generator=torch.Generator()
                          .manual_seed(2)).to(getattr(torch, dtype))
        got.append(_saved_bytes(cfg, acfg, True, {"img_embed": img}))
        want.append(job_activation_bytes(cfg, job))
    assert got[1] - got[0] == want[1] - want[0]
    assert want[1] >= got[1]


def test_working_term_counts_the_image_batch():
    """``job_working_bytes`` of a VLM job: its batch part is the bytes a
    step's batch of the job's stream holds (ids and the image prefix), the
    rest the FFN's three gradients over Ti + S positions and seven
    adapter-sized trees."""
    from repro_torch.core.adapters import adapter_bytes
    from repro_torch.training import job_working_bytes, make_job_stream
    pc = port_config(tiny(VLM))
    acfg = pcfg.AdapterConfig(**LORA)
    job = FinetuneJob(acfg=acfg, data=None, batch_size=B, seq_len=S, steps=1)
    batch = make_job_stream(pc, B, S, seed=1, device="cpu").batch(0)
    held = sum(t.numel() * t.element_size() for t in batch.values())
    T = B * (pc.n_frontend_tokens + S)
    assert job_working_bytes(pc, job) == \
        3 * T * pc.d_ff * 4 + 7 * adapter_bytes(pc, acfg)[1] + held
