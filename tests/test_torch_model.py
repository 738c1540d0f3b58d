"""PyTorch port vs the JAX reference: weights carried across, and the
compacted prefill and decode steps of a tiny fp32 dense model with a
non-zero LoRA bank, over bf16-layout (here fp32) and int8 page pools.

Logits are held at atol = rtol = 1e-4 (two layers of matmuls summed in
another order), pool contents at 1e-5 on the pages the tables name. With
int8 pools, logits at 1e-3 and scales at rtol 1e-5; the int8 entries may
differ by one where the K/V projections, summed in another order, land on
the other side of a rounding boundary. The port writes its pools in place:
their ``data_ptr()`` never changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, ServeConfig, DENSE
from repro.core import symbiosis as jax_sym
from repro.models import blocks as jax_blocks
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import get_model
from repro_torch.models import blocks as port_blocks
from conftest import tiny

C, B_SLOTS, MAX_SEQ, BLK = 3, 2, 32, 8
SENTINEL = 1 << 30
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
QUANT_LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)
SCALE_TOL = dict(atol=0, rtol=1e-5)

CONFIGS = {
    "tiny": dict(),
    "hd128_g4": dict(d_model=256, n_heads=8, n_kv_heads=2, head_dim=128,
                     d_ff=256),
}


def port_config(cfg):
    """The port's copy of a JAX ModelConfig (same fields)."""
    return pcfg.ModelConfig(**{f: getattr(cfg, f) for f in
                               pcfg.ModelConfig.__dataclass_fields__})


def numpy_base(cfg, seed):
    """Base params in the JAX package's layout, drawn with numpy from its
    init distributions (norm scales jittered around 1 so they matter)."""
    rng = np.random.default_rng(seed)
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.hd
    H, K, F = cfg.hp, cfg.n_kv_heads, cfg.d_ff

    def lin(din, dout, lead=()):
        s = 1.0 / np.sqrt(din)
        return rng.uniform(-s, s, lead + (din, dout)).astype(np.float32)

    def scale(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {"embed": (rng.standard_normal((cfg.vocab, d)) * 0.02)
            .astype(np.float32),
            "final_norm": {"scale": scale(d)},
            "lm_head": lin(d, cfg.vocab),
            "layers": {"ln1": {"scale": scale(L, d)},
                       "ln2": {"scale": scale(L, d)},
                       "attn": {"wq": lin(d, H * hd, (L,)),
                                "wk": lin(d, K * hd, (L,)),
                                "wv": lin(d, K * hd, (L,)),
                                "wo": lin(H * hd, d, (L,))},
                       "mlp": {"gate": lin(d, F, (L,)), "up": lin(d, F, (L,)),
                               "down": lin(F, d, (L,))}}}


def numpy_bank(cfg, acfg, n_clients, seed):
    """A client-stacked LoRA bank with A AND B non-zero and different per
    client (a fresh bank's B is zero, which would hide the SGMV routing)."""
    rng = np.random.default_rng(seed)
    L, r = cfg.n_layers, acfg.rank
    dims = {"q": (cfg.d_model, cfg.hp * cfg.hd),
            "v": (cfg.d_model, cfg.n_kv_heads * cfg.hd)}
    return {"layers": {t: {
        "A": (rng.standard_normal((n_clients, L, din, r)) / np.sqrt(din))
        .astype(np.float32),
        "B": (rng.standard_normal((n_clients, L, r, dout)) * 0.5)
        .astype(np.float32)} for t, (din, dout) in dims.items()
        if t in acfg.targets}}


def make_system(name, seed=0):
    cfg = tiny(DENSE, **CONFIGS[name])
    acfg = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
    return cfg, acfg, numpy_base(cfg, seed), numpy_bank(cfg, acfg, C, seed)


def test_params_round_trip():
    cfg, _, np_base, _ = make_system("tiny")
    params = convert.params_from_numpy(port_config(cfg), np_base, "cpu")
    assert len(params["layers"]) == cfg.n_layers
    back = convert.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(np_base)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_bf16_leaves_cross_exactly():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 17), jnp.bfloat16))
    t = convert.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    np.testing.assert_array_equal(convert.tensor_to_numpy(t).view(np.uint16),
                                  a.view(np.uint16))


def _table(lengths, rows, P):
    """Global block table for the bank: row (c, s) of ``rows`` maps enough
    pages of client c's range for its prompt and one decode token."""
    n_blocks = MAX_SEQ // BLK
    tbl = np.full((C, B_SLOTS, n_blocks), SENTINEL, np.int32)
    nxt = [c * P for c in range(C)]
    for (c, s), L in zip(rows, lengths):
        need = L // BLK + 1
        tbl[c, s, :need] = np.arange(nxt[c], nxt[c] + need)
        nxt[c] += need
    return tbl


def _named_pages(tbl, Pl, L):
    pages = np.unique(tbl[tbl < SENTINEL])
    return np.concatenate([pages + i * Pl for i in range(L)])


def _assert_pools(port_caches, jax_caches, pages):
    """Pools on the named pages, and positions. int8 entries may differ by
    one on at most 0.1% of the written entries (rows whose scale is set);
    returns the count of entries that differ."""
    got = convert.caches_to_numpy(port_caches)
    flat = {}
    for leaf in got["layers"]:
        g = got["layers"][leaf]
        w = np.asarray(jax_caches["layers"][leaf])
        flat[leaf] = (g.reshape((-1,) + g.shape[2:])[pages],
                      w.reshape((-1,) + w.shape[2:])[pages])
    np.testing.assert_array_equal(got["pos"], np.asarray(jax_caches["pos"]))
    if "k_s" not in flat:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(*flat[leaf], **POOL_TOL)
        return 0
    n_diff = 0
    for leaf in ("k", "v"):
        g, w = flat[leaf]
        np.testing.assert_allclose(*flat[leaf + "_s"], **SCALE_TOL)
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        written = (flat[leaf + "_s"][1] > 0).sum() * g.shape[-1]
        assert diff.max() <= 1, f"{leaf}: int8 entries differ by {diff.max()}"
        assert (diff > 0).sum() <= 1e-3 * written, \
            f"{leaf}: {(diff > 0).sum()} of {written} int8 entries differ"
        n_diff += int((diff > 0).sum())
    return n_diff


def _compact_prefill_and_decode(name, quant):
    """Compacted prefill then one decode step of the same rows, in both
    packages; pools checked after each. Returns the count of int8 entries
    that differ (0 unquantized)."""
    cfg, acfg, np_base, np_bank = make_system(name, seed=1)
    pc = port_config(cfg)
    pacfg = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0,
                               targets=("q", "v"))
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK,
                       kv_quant=quant)
    pscfg = pcfg.ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK,
                             kv_quant=quant)
    logit_tol = QUANT_LOGIT_TOL if quant else LOGIT_TOL
    P = B_SLOTS * (MAX_SEQ // BLK)
    rng = np.random.default_rng(2)

    # three admitted rows across clients + one padding row (client 0 slot 0)
    rows = [(0, 1), (2, 0), (1, 1)]
    lengths = [5, 8, 11]
    S_pad = 16
    n = 4
    toks = np.zeros((n, S_pad), np.int32)
    for r, L in enumerate(lengths):
        toks[r, :L] = rng.integers(0, cfg.vocab, L)
    lens = np.array(lengths + [0], np.int32)
    clients = np.array([c for c, _ in rows] + [0], np.int32)
    slots = np.array([s for _, s in rows] + [0], np.int32)
    mask = np.array([True] * 3 + [False])
    tbl = _table(lengths, rows, P)

    jcaches = jax_sym.init_client_caches(cfg, C, B_SLOTS, MAX_SEQ,
                                         page_block=BLK, pool_pages=P,
                                         quant=quant)
    jcaches = dict(jcaches, block_tbl=jnp.asarray(tbl))
    pcaches = convert.caches_from_numpy(jax.tree.map(np.asarray, jcaches),
                                        "cpu")
    assert sorted(pcaches["layers"]) == (["k", "k_s", "v", "v_s"] if quant
                                         else ["k", "v"])
    ptrs = {k: t.data_ptr() for k, t in pcaches["layers"].items()}
    base_t = convert.params_from_numpy(pc, np_base, "cpu")
    bank_t = convert.bank_from_numpy(pacfg, np_bank, "cpu")
    jbank = jax.tree.map(jnp.asarray, np_bank)
    jbase = jax.tree.map(jnp.asarray, np_base)
    pages = _named_pages(tbl, C * P, cfg.n_layers)

    jpre = jax.jit(jax_sym.make_compact_prefill(cfg, acfg, scfg))
    jlg, jcaches = jpre(jbase, jbank, jcaches, jnp.asarray(toks),
                        jnp.asarray(lens), jnp.zeros((n,), jnp.int32),
                        jnp.asarray(clients), jnp.asarray(slots),
                        jnp.asarray(mask))
    ppre = port_sym.make_compact_prefill(pc, pacfg, pscfg)
    plg, _, pcaches = ppre(base_t, bank_t, pcaches,
                           *(torch.from_numpy(a) for a in
                             (toks, lens, np.zeros(n, np.int32), clients,
                              slots, mask)))
    np.testing.assert_allclose(plg.numpy()[:3], np.asarray(jlg)[:3],
                               **logit_tol)
    n_diff = _assert_pools(pcaches, jcaches, pages)

    # one decode step for the same rows; padding row again aliases (0, 0)
    nxt = np.append(np.asarray(jlg)[:3].argmax(-1), 0).astype(np.int32)
    jdec = jax.jit(jax_sym.make_compact_decode_step(cfg, acfg, scfg))
    jlg2, jcaches = jdec(jbase, jbank, jcaches, jnp.asarray(nxt),
                         jnp.asarray(clients), jnp.asarray(slots),
                         jnp.asarray(mask))
    pdec = port_sym.make_compact_decode_step(pc, pacfg, pscfg)
    plg2, finite, pcaches = pdec(base_t, bank_t, pcaches,
                                 *(torch.from_numpy(a) for a in
                                   (nxt, clients, slots, mask)))
    assert finite.all()
    np.testing.assert_allclose(plg2.numpy()[:3], np.asarray(jlg2)[:3],
                               **logit_tol)
    n_diff += _assert_pools(pcaches, jcaches, pages)
    assert {k: t.data_ptr() for k, t in pcaches["layers"].items()} == ptrs
    return n_diff


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compact_prefill_and_decode_match_reference(name):
    _compact_prefill_and_decode(name, quant=False)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quant_compact_prefill_and_decode_match_reference(name):
    """int8 pools (``kv_quant=True``) against the JAX steps. The count of
    int8 entries that differ is printed; it was 0 in both configurations
    on the CPU when this test was written."""
    n_diff = _compact_prefill_and_decode(name, quant=True)
    print(f"{name}: {n_diff} int8 entries differ from the JAX package's")


def test_lora_delta_reaches_logits():
    """A non-zero bank changes the logits against the same bank with B
    zeroed (the SGMV path is live)."""
    cfg, _, np_base, np_bank = make_system("tiny", seed=3)
    pc = port_config(cfg)
    pacfg = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0,
                               targets=("q", "v"))
    pscfg = pcfg.ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    base_t = convert.params_from_numpy(pc, np_base, "cpu")
    bank_t = convert.bank_from_numpy(pacfg, np_bank, "cpu")
    P = B_SLOTS * (MAX_SEQ // BLK)
    toks = torch.from_numpy(np.arange(12, dtype=np.int32).reshape(2, 6) % 50)
    args = (toks, torch.tensor([6, 6], dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32),
            torch.tensor([0, 0], dtype=torch.int32), torch.tensor([True, True]))
    zero_b = {"layers": {t: {"A": leaf["A"],
                             "B": torch.zeros_like(leaf["B"])}
                         for t, leaf in bank_t["layers"].items()}}
    outs = []
    for bank in (bank_t, zero_b):
        caches = port_sym.init_client_caches(pc, C, B_SLOTS, MAX_SEQ,
                                             page_block=BLK, pool_pages=P,
                                             device="cpu")
        caches["block_tbl"] = torch.from_numpy(
            _table([6, 6], [(0, 0), (1, 0)], P))
        fn = port_sym.make_compact_prefill(pc, pacfg, pscfg)
        outs.append(fn(base_t, bank, caches, *args)[0])
    assert not torch.allclose(outs[0], outs[1])
    assert not torch.allclose(outs[0][0], outs[0][1])


def test_client_ctx_equals_compact_rows():
    """Each client's prefill alone, through ``make_client_ctx`` (the LoRA
    delta as x @ A @ B inline), equals its row of the compacted prefill
    (the delta through SGMV) on the same weights."""
    cfg, _, np_base, np_bank = make_system("tiny", seed=4)
    pc = port_config(cfg)
    pacfg = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0,
                               targets=("q", "v"))
    pscfg = pcfg.ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    base_t = convert.params_from_numpy(pc, np_base, "cpu")
    bank_t = convert.bank_from_numpy(pacfg, np_bank, "cpu")
    P = B_SLOTS * (MAX_SEQ // BLK)
    rng = np.random.default_rng(4)
    lengths = np.array([7, 3, 10], np.int32)
    toks = np.zeros((C, 12), np.int32)
    for c, L in enumerate(lengths):
        toks[c, :L] = rng.integers(0, cfg.vocab, L)
    caches = port_sym.init_client_caches(pc, C, B_SLOTS, MAX_SEQ,
                                         page_block=BLK, pool_pages=P,
                                         device="cpu")
    caches["block_tbl"] = torch.from_numpy(
        _table(list(lengths), [(c, 0) for c in range(C)], P))
    compact, _, _ = port_sym.make_compact_prefill(pc, pacfg, pscfg)(
        base_t, bank_t, caches, torch.from_numpy(toks),
        torch.from_numpy(lengths), torch.zeros(C, dtype=torch.int32),
        torch.arange(C, dtype=torch.int32),
        torch.zeros(C, dtype=torch.int32), torch.ones(C, dtype=torch.bool))
    model = get_model(pc)
    ctx = make_client_ctx(pc, pacfg)
    for c in range(C):
        adapter = {"layers": {t: {m: leaf[m][c] for m in ("A", "B")}
                              for t, leaf in bank_t["layers"].items()}}
        cache = model.init_cache(1, MAX_SEQ, page_block=BLK, device="cpu")
        solo, _ = model.prefill(base_t, {"tokens": torch.from_numpy(
            toks[c:c + 1])}, cache, ctx, adapter,
            lengths=torch.from_numpy(lengths[c:c + 1]))
        np.testing.assert_allclose(solo[0].numpy(), compact[c].numpy(),
                                   **POOL_TOL)


WRITE_CASES = {   # (active, pos) over 5 rows; row 4 aliases row 0's table
    "some_rows_dropped": ([True, False, True, True, False],
                          [3, 9, 17, 8, 3]),
    "nothing_kept": ([False] * 5, [3, 9, 17, 8, 3]),
}


def _write_fixture(seed):
    rng = np.random.default_rng(seed)
    P, blk, K, hd, nb = 32, 4, 2, 8, 6
    pool = rng.standard_normal((P, blk, K, hd)).astype(np.float32)
    tbl = rng.permutation(P)[:5 * nb].reshape(5, nb).astype(np.int32)
    tbl[4] = tbl[0]
    tbl[3, 2:] = SENTINEL                    # row 3's pos 8 is unmapped
    return rng, pool, tbl, (P, blk, K, hd, nb)


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_token_write_drops_like_reference(case):
    """The port's fixed-shape decode write equals JAX's scatter with
    ``mode="drop"`` bit for bit: inactive rows, a padding row aliasing a
    live one and an unmapped (sentinel) page all leave the pool as it
    was; the index keeps one entry per row whatever is dropped."""
    active, pos = WRITE_CASES[case]
    rng, pool, tbl, (P, blk, K, hd, _) = _write_fixture(5)
    x = rng.standard_normal((5, K, hd)).astype(np.float32)
    want = jax_blocks.paged_token_write(
        jnp.asarray(pool), jnp.asarray(tbl), jnp.asarray(pos, jnp.int32),
        jnp.asarray(x), jnp.asarray(active))
    got = torch.from_numpy(pool.copy())
    index = port_blocks.token_write_index(
        torch.from_numpy(tbl), torch.tensor(pos, dtype=torch.int32), P, blk,
        torch.tensor(active))
    assert all(t.shape == (5,) for t in index[:3])
    port_blocks.paged_write(got, index, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not any(active):
        np.testing.assert_array_equal(got.numpy(), pool)


@pytest.mark.parametrize("lengths", [[5, 0, 11, 3, 0], [0] * 5])
def test_prefill_write_drops_like_reference(lengths):
    """As above for a prefill: positions at or past each row's length, and
    a table entry holding the sentinel, never touch the pool."""
    rng, pool, tbl, (P, blk, K, hd, nb) = _write_fixture(6)
    S = 12
    tbl[2, 2] = SENTINEL                     # inside row 2's length
    x = rng.standard_normal((5, S, K, hd)).astype(np.float32)
    want = jax_blocks.paged_prefill_write(
        jnp.asarray(pool), jnp.asarray(tbl), jnp.asarray(x),
        lengths=jnp.asarray(lengths, jnp.int32))
    got = torch.from_numpy(pool.copy())
    index = port_blocks.prefill_write_index(
        torch.from_numpy(tbl), S, P, blk,
        torch.tensor(lengths, dtype=torch.int32))
    assert all(t.shape == (5 * S,) for t in index[:3])
    port_blocks.paged_write(got, index, torch.from_numpy(x).flatten(0, 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
