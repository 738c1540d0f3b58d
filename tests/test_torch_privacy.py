"""PyTorch port vs the JAX reference: activation privacy (paper §3.8),
mirroring tests/test_privacy.py.

Noise, weights and adapters are drawn by numpy and handed to both
packages (the port draws its own noise from a ``torch.Generator``, JAX from
``jax.random``: a stated departure). Checked on tiny fp32 configs:

* ``private_dense`` cancels exactly on a linear (JAX's bound), and equals
  JAX's at 1e-5; the variant rotation; ``noise_effect`` on a 2-D weight,
  a stacked [L, din, dout] one and the port's per-layer list;
* ``attach_privacy``'s per-layer ``_priv`` entries equal JAX's stacked
  leaves at 1e-5;
* a tiny dense model's private forward against JAX's private forward at
  1e-5, and against the port's plain forward at 2e-3 (JAX's own bound);
* gradients through the private context equal the plain ones (JAX's
  ``rtol=5e-2, atol=1e-4``);
* an MoE base's first dense layer (JAX's ``pre_layers``, folded into the
  port's ``layers``) carries no noise: its products are bit for bit the
  plain context's;
* JAX's inert switches are not copied: the serve CLI refuses
  ``--privacy`` (pointing to the client context) as well as ``--mesh``,
  and the port's ``ServeConfig`` has no ``privacy`` field.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import DENSE, MOE, ServeConfig as JaxServeConfig
from repro.core import privacy as jax_privacy
from repro.core.frozen_linear import frozen_dense as jax_frozen_dense
from repro.core.virtlayer import attach_privacy as jax_attach
from repro.core.virtlayer import make_client_ctx as jax_client_ctx
from repro.models import get_model as jax_get_model
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import attach_privacy, privacy
from repro_torch.core.frozen_linear import frozen_dense
from repro_torch.core.virtlayer import PRIV_KEY, make_client_ctx
from repro_torch.models import get_model
from repro_torch.models.transformer import _adapter_layer
from conftest import tiny
from test_torch_model import numpy_base, port_config
from test_torch_moe import jax_bank, numpy_params
from test_torch_rwkv import one_thread  # noqa: F401  (module fixture)
from test_torch_train import ACFG, PACFG, numpy_adapter

TOL = dict(atol=1e-5, rtol=1e-5)
PLAIN_TOL = dict(atol=2e-3, rtol=2e-3)        # JAX's private-vs-plain bound
GRAD_TOL = dict(atol=1e-4, rtol=5e-2)         # JAX's gradient bound


def numpy_noise(dims, n_variants, scale, seed):
    rng = np.random.default_rng(seed)
    return {p: (rng.standard_normal((n_variants, din)) * scale)
            .astype(np.float32) for p, (din, _) in sorted(dims.items())}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _dims(cfg, paths=("q", "v")):
    d, hd = cfg.d_model, cfg.hd
    all_dims = {"q": (d, cfg.hp * hd), "k": (d, cfg.n_kv_heads * hd),
                "v": (d, cfg.n_kv_heads * hd), "o": (cfg.hp * hd, d),
                "gate": (d, cfg.d_ff), "up": (d, cfg.d_ff),
                "down": (cfg.d_ff, d)}
    return {p: all_dims[p] for p in paths}


# ---------------------------------------------------------------------------
# the protocol

def test_exact_cancellation_linear():
    """y = ((x+n)W + b) - nW == xW + b up to re-association, as JAX's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    n = (rng.standard_normal((16,)) * 10.0).astype(np.float32)
    eff = n @ w
    got = privacy.private_dense(frozen_dense, *_t((x, w, b)), "q",
                                *_t((n, eff)))
    np.testing.assert_allclose(got.numpy(), x @ w + b, rtol=1e-4, atol=1e-4)
    want = jax_privacy.private_dense(jax_frozen_dense, *_j((x, w, b)), "q",
                                     *_j((n, eff)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # what the executor sees (x + n) does not reveal x
    assert float((torch.from_numpy(x + n) - torch.from_numpy(x))
                 .abs().min()) > 0.1


def test_variant_rotation_and_noise_effect_match_reference():
    dims = {"q": (16, 8), "v": (16, 12)}
    noise = numpy_noise(dims, 3, 1.0, 1)
    rng = np.random.default_rng(2)
    w2 = {p: rng.standard_normal(d).astype(np.float32)
          for p, d in dims.items()}
    w3 = {p: rng.standard_normal((3,) + d).astype(np.float32)
          for p, d in dims.items()}
    pn = _t(noise)
    for w in (w2, w3):
        want = jax_privacy.noise_effect(_j(noise), _j(w))
        got = privacy.noise_effect(pn, _t(w))
        for p in dims:
            np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                       **TOL)
    # the port's per-layer lists stack to [L, V, dout]
    listed = privacy.noise_effect(pn, {p: list(_t(w3[p])) for p in dims})
    for p in dims:
        assert listed[p].shape == (3, 3, dims[p][1])
        np.testing.assert_allclose(
            listed[p].numpy(),
            np.asarray(jax_privacy.noise_effect(_j(noise), _j(w3))[p]), **TOL)
    eff = privacy.noise_effect(pn, _t(w2))
    for v in range(3):
        nv = privacy.select_variant(pn, "q", v)
        assert torch.equal(nv, pn["q"][v])
        np.testing.assert_allclose(eff["q"][v].numpy(),
                                   nv.numpy() @ w2["q"], rtol=1e-5)
        assert torch.equal(privacy.select_variant(listed, "v", v),
                           listed["v"][:, v])


def test_make_noise_draws_from_the_generator():
    dims = {"v": (16, 8), "q": (24, 8)}
    a = privacy.make_noise(torch.Generator().manual_seed(5), dims,
                           n_variants=3, scale=2.0, dtype=torch.bfloat16)
    b = privacy.make_noise(torch.Generator().manual_seed(5), dims,
                           n_variants=3, scale=2.0, dtype=torch.bfloat16)
    assert {p: tuple(t.shape) for p, t in a.items()} == {"q": (3, 24),
                                                         "v": (3, 16)}
    assert all(t.dtype == torch.bfloat16 for t in a.values())
    assert all(torch.equal(a[p], b[p]) for p in dims)
    big = privacy.make_noise(torch.Generator().manual_seed(6),
                             {"q": (4096, 8)}, n_variants=4, scale=3.0)
    assert abs(float(big["q"].std()) - 3.0) < 0.1


# ---------------------------------------------------------------------------
# attach_privacy and the private context

def _dense_system(seed=21):
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    np_base = numpy_base(cfg, seed)
    return cfg, pc, np_base, convert.params_from_numpy(pc, np_base, "cpu")


ALL_PATHS = ("q", "k", "v", "o", "gate", "up", "down")


def test_attach_privacy_matches_reference():
    cfg, pc, np_base, base = _dense_system()
    noise = numpy_noise(_dims(cfg, ALL_PATHS), 2, 3.0, 9)
    ad = numpy_adapter(cfg, 7)
    want = jax_attach(_j(ad), cfg, _j(np_base), _j(noise))["layers"][PRIV_KEY]
    got = attach_privacy(_t(ad), pc, base, _t(noise))
    entries = got["layers"][PRIV_KEY]
    assert len(entries) == cfg.n_layers
    assert set(entries[0]) == set(want) == set(ALL_PATHS)
    for p in ALL_PATHS:
        stacked = torch.stack([e[p] for e in entries])
        np.testing.assert_allclose(stacked.numpy(), np.asarray(want[p]), **TOL)
    # the adapter's own leaves ride beside, untouched
    assert got["layers"]["q"] is not None
    assert set(got["layers"]) == {"q", "v", PRIV_KEY}


def _private_pair(cfg, pc, np_base, base, variant=1, scale=3.0):
    ad = numpy_adapter(cfg, 7)
    noise = numpy_noise(_dims(cfg), 2, scale, 9)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    jad = jax_attach(_j(ad), cfg, _j(np_base), _j(noise))
    pad = attach_privacy(_t(ad), pc, base, _t(noise))
    return ad, noise, tokens, jad, pad


def test_private_forward_matches_reference_and_plain():
    """The paper: 'the model produces the exact output which it otherwise
    would have'."""
    cfg, pc, np_base, base = _dense_system()
    ad, noise, tokens, jad, pad = _private_pair(cfg, pc, np_base, base)
    jctx = jax_client_ctx(cfg, ACFG, privacy_noise=_j(noise),
                          privacy_variant=1)
    want, _ = jax_get_model(cfg).forward(_j(np_base), {"tokens": tokens},
                                         jctx, jad)
    model = get_model(pc)
    batch = {"tokens": torch.from_numpy(tokens)}
    got = model.forward(base, batch, make_client_ctx(
        pc, PACFG, privacy_noise=_t(noise), privacy_variant=1), pad)
    plain = model.forward(base, batch, make_client_ctx(pc, PACFG), _t(ad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **PLAIN_TOL)
    assert not torch.equal(got, plain)        # the noise did run


def test_private_grads_equal_plain():
    """Linearity: the cancellation holds in the backward too."""
    cfg, pc, np_base, base = _dense_system()
    ad = numpy_adapter(cfg, 7)
    noise = _t(numpy_noise(_dims(cfg), 2, 2.0, 9))
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)))}
    model = get_model(pc)

    def grads(ctx, tree):
        leaves = [t.requires_grad_() for t in
                  tree_leaves({k: tree["layers"][k] for k in ("q", "v")})]
        logits = model.forward(base, batch, ctx, tree)
        return torch.autograd.grad((logits ** 2).mean(), leaves)

    g_p = grads(make_client_ctx(pc, PACFG, privacy_noise=noise),
                attach_privacy(_t(ad), pc, base, noise))
    g_0 = grads(make_client_ctx(pc, PACFG), _t(ad))
    for a, b in zip(g_p, g_0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_moe_first_dense_layer_carries_no_noise():
    """JAX's ``attach_privacy`` covers its stacked ``layers``: an MoE
    base's ``pre_layers`` run plain. The port folds them into ``layers``
    and gives them a ``None`` entry."""
    cfg = tiny(MOE)
    pc = port_config(cfg)
    np_base = numpy_params(cfg, 3)
    base = convert.params_from_numpy(pc, np_base, "cpu")
    noise = numpy_noise(_dims(cfg, ("q", "v", "o")), 2, 3.0, 9)
    port_ad = numpy_adapter(cfg, 7)
    jad = jax_bank(cfg, jax.tree.map(lambda a: a[None], port_ad))
    jad = jax.tree.map(lambda a: a[0], jad)
    want = jax_attach(_j(jad), cfg, _j(np_base), _j(noise))["layers"][PRIV_KEY]
    got = attach_privacy(_t(port_ad), pc, base, _t(noise))
    entries = got["layers"][PRIV_KEY]
    n_pre = cfg.first_dense_layers
    assert n_pre == 1 and entries[0] is None
    for p in ("q", "v", "o"):
        np.testing.assert_allclose(
            torch.stack([e[p] for e in entries[n_pre:]]).numpy(),
            np.asarray(want[p]), **TOL)
    # layer 0 takes the plain product bit for bit; layer 1 the noisy one
    priv = make_client_ctx(pc, PACFG, privacy_noise=_t(noise))
    plain = make_client_ctx(pc, PACFG)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32))
    for i, same in ((0, True), (1, False)):
        w = base["layers"][i]["attn"]["wq"]
        a = priv.for_layer(_adapter_layer(got, i)).dense(x, w, None, "q")
        b = plain.for_layer(_adapter_layer(_t(port_ad), i)).dense(
            x, w, None, "q")
        assert torch.equal(a, b) is same
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PLAIN_TOL)


def test_attach_privacy_refuses_other_families():
    pc = port_config(tiny("rwkv"))
    with pytest.raises(ValueError, match="dense, MoE and VLM"):
        attach_privacy({}, pc, {"layers": []}, {})


# ---------------------------------------------------------------------------
# JAX's inert switches, not copied

def test_serve_config_has_no_privacy_switch():
    """JAX's ``ServeConfig.privacy`` is read by nothing; the port leaves
    the field out, so a caller who sets it hears so."""
    assert JaxServeConfig().privacy is False
    with pytest.raises(TypeError, match="privacy"):
        pcfg.ServeConfig(privacy=True)


def test_serve_cli_refuses_privacy_and_mesh():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="make_client_ctx"):
        serve.main(["--device", "cpu", "--privacy", "--clients", "2"])
    with pytest.raises(SystemExit, match="not ported yet"):
        serve.main(["--device", "cpu", "--mesh", "1", "1"])
