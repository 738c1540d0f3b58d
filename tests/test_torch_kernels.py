"""PyTorch port vs the JAX reference: the ported kernels (decode attention
over a dense cache, paged over bf16/fp32 and over int8 pools, SGMV), the
int8 K/V quantizer and the kernel package's public names.

On the CPU the port's ops run their plain versions and the JAX ops run
their jnp stream twins (``interpret=None``; the dense decode op runs its
Pallas kernel in interpret mode), so this holds the port's blocked math
against the reference's at atol = rtol = 1e-5 (fp32; the two frameworks
sum in different orders). The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import decode_attn as jax_decode_attn
from repro.kernels.decode_attn.decode_attn import (
    paged_decode_attn_quant_stream as jax_quant_stream)
from repro.kernels.decode_attn.ref import decode_attn_ref as jax_decode_ref
from repro.kernels.sgmv import sgmv as jax_sgmv
from repro.kernels.sgmv import sgmv_ref as jax_sgmv_ref
import repro.kernels as jax_kernels
from repro.models.blocks import quantize_head as jax_quantize_head
import repro_torch.kernels as port_kernels
from repro_torch import convert
from repro_torch.models.blocks import quantize_head

# the subpackages (``repro_torch.kernels.decode_attn`` as an attribute is
# the op, as in the JAX package)
port_da = importlib.import_module("repro_torch.kernels.decode_attn")
port_sgmv = importlib.import_module("repro_torch.kernels.sgmv")
da_mod = importlib.import_module("repro_torch.kernels.decode_attn.decode_attn")

TOL = dict(atol=1e-5, rtol=1e-5)
SENTINEL = 1 << 30


def _paged_case(B, K, G, hd, P, blk, nb, seed, pos=None, sentinel=False):
    """Pools, a scattered block table and positions; with ``sentinel`` the
    entries past each row's last page hold the out-of-range sentinel plus
    a layer-style offset, as the engine's tables do."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    pk = rng.standard_normal((P, blk, K, hd)).astype(np.float32)
    pv = rng.standard_normal((P, blk, K, hd)).astype(np.float32)
    tbl = rng.permutation(P)[:B * nb].reshape(B, nb).astype(np.int32)
    if pos is None:
        pos = rng.integers(0, nb * blk, B)
    pos = np.asarray(pos, np.int32)
    if sentinel:
        for b in range(B):
            tbl[b, pos[b] // blk + 1:] = SENTINEL + 3 * P
    return q, pk, pv, tbl, pos


# (B, K, G, hd, P, blk, nb, window, pos, sentinel)
PAGED_CASES = {
    "standard": (3, 2, 2, 32, 16, 8, 4, 0, None, False),
    "odd_pool": (2, 1, 4, 64, 11, 16, 3, 0, None, False),
    "window": (3, 2, 2, 32, 16, 8, 4, 12, None, False),
    "pos0_and_page_edges": (5, 2, 2, 32, 24, 8, 4, 0, [0, 7, 8, 15, 31], True),
    "sentinel_window": (4, 2, 2, 32, 20, 8, 5, 10, None, True),
    "granite_heads": (3, 8, 4, 128, 12, 16, 4, 0, [0, 16, 40], True),
}


def _jax_paged(q, pk, pv, tbl, pos, window):
    return np.asarray(jax_decode_attn(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pos),
        block_tbl=jnp.asarray(tbl), window=window))


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_decode_attn_matches_reference(name):
    B, K, G, hd, P, blk, nb, window, pos, sentinel = PAGED_CASES[name]
    q, pk, pv, tbl, pos = _paged_case(B, K, G, hd, P, blk, nb, seed=len(name),
                                      pos=pos, sentinel=sentinel)
    want = _jax_paged(q, pk, pv, tbl, pos, window)
    got = port_da.decode_attn(torch.from_numpy(q), torch.from_numpy(pk),
                              torch.from_numpy(pv), torch.from_numpy(pos),
                              block_tbl=torch.from_numpy(tbl), window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [0, 12])
def test_decode_attn_ref_matches_reference_ref(window):
    q, pk, pv, tbl, pos = _paged_case(3, 2, 2, 32, 16, 8, 4, seed=3,
                                      sentinel=True)
    want = np.asarray(jax_decode_ref(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pos),
        window=window, block_tbl=jnp.asarray(tbl)))
    got = port_da.decode_attn_ref(torch.from_numpy(q), torch.from_numpy(pk),
                                  torch.from_numpy(pv), torch.from_numpy(pos),
                                  window=window,
                                  block_tbl=torch.from_numpy(tbl))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_paged_matches_oracle():
    """The blocked online softmax equals the full softmax (port alone)."""
    q, pk, pv, tbl, pos = _paged_case(4, 2, 4, 64, 20, 8, 5, seed=9,
                                      sentinel=True)
    args = [torch.from_numpy(a) for a in (q, pk, pv)]
    got = port_da.paged_decode_attn_plain(*args, torch.from_numpy(tbl),
                                          torch.from_numpy(pos), window=9)
    want = port_da.decode_attn_ref(*args, torch.from_numpy(pos), window=9,
                                   block_tbl=torch.from_numpy(tbl))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# dense caches: (B, T, K, G, hd, block_kv, window, pos); T = 32 divides the
# block, T = 40 makes ``_dense_block_kv`` shrink it to 10, T = 37 (prime)
# pads it to 48; pos -1 (nothing to attend) and T - 1 (the whole cache)
DENSE_CASES = {
    "divides": (3, 32, 2, 2, 16, 16, 0, [0, 17, 31]),
    "divides_window": (3, 32, 2, 2, 16, 16, 9, [4, 20, 31]),
    "shrinks_40_to_10": (2, 40, 2, 4, 16, 16, 0, [39, 12]),
    "shrinks_window": (2, 40, 1, 4, 16, 16, 13, [39, 25]),
    "prime_pads": (3, 37, 2, 2, 16, 16, 0, [36, 0, 20]),
    "prime_pads_window": (2, 37, 2, 1, 32, 16, 7, [36, 30]),
    "pos_minus_one": (3, 32, 2, 2, 16, 16, 0, [-1, 31, -1]),
    "granite_heads": (2, 24, 8, 4, 128, 512, 0, [23, 5]),
}


def _dense_case(B, T, K, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_decode_attn_matches_reference(name):
    B, T, K, G, hd, bkv, window, pos = DENSE_CASES[name]
    q, k, v = _dense_case(B, T, K, G, hd, seed=len(name))
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jax_decode_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        block_kv=bkv, window=window))
    got = port_da.decode_attn(*(torch.from_numpy(a) for a in (q, k, v, pos)),
                              block_kv=bkv, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dead = pos < 0            # nothing to attend: exact zeros, as the kernel
    assert not got[dead].any() and not want[dead].any()
    live = ~dead
    np.testing.assert_allclose(got[live], np.asarray(jax_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        window=window))[live], **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_dense_decode_attn_ref_matches_reference_ref(window):
    """pos = -1 included: the oracle's full softmax over all-masked scores
    is the mean of V (the op's kernel gives zeros there)."""
    q, k, v = _dense_case(3, 20, 2, 2, 16, seed=4)
    pos = np.asarray([19, -1, 7], np.int32)
    want = np.asarray(jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(pos),
                                     window=window))
    got = port_da.decode_attn_ref(*(torch.from_numpy(a)
                                    for a in (q, k, v, pos)),
                                  window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[1]).max() > 0


def test_dense_bf16_matches_reference():
    q, k, v = _dense_case(2, 40, 2, 4, 32, seed=5)
    pos = np.asarray([39, 11], np.int32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_decode_attn(*bf, jnp.asarray(pos), block_kv=16))
    got = port_da.decode_attn(*(convert.tensor_from_numpy(np.asarray(a), "cpu")
                                for a in bf), torch.from_numpy(pos),
                              block_kv=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=2e-2, rtol=2e-2)


def test_dense_chunks_do_not_change_the_result():
    """The CUDA kernel's split is its own (``DENSE_SPLIT``): chunking
    changes only the summation order."""
    q, k, v = (torch.from_numpy(a) for a in _dense_case(3, 37, 2, 2, 16, 6))
    pos = torch.tensor([36, 3, 20], dtype=torch.int32)
    a = port_da.decode_attn_plain(q, k, v, pos, block_kv=8, window=11)
    b = port_da.decode_attn_plain(q, k, v, pos, block_kv=da_mod.DENSE_SPLIT,
                                  window=11)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# the dense kernel's split-and-combine math: (B, T, K, G, hd, split,
# window, pos). Splits that divide T, that do not, and one longer than T;
# windows whose edge leaves each row one partial live split; pos -1 rows.
SPLIT_CASES = {
    "split_divides": (3, 32, 2, 2, 16, 8, 0, [0, 17, 31]),
    "split_does_not_divide": (3, 37, 2, 2, 16, 8, 0, [36, 0, 20]),
    "split_exceeds_t": (2, 20, 1, 4, 16, 64, 0, [19, 7]),
    "window_one_partial_split": (3, 40, 2, 2, 16, 16, 5, [20, 39, 9]),
    "window_across_splits": (2, 40, 2, 1, 32, 8, 13, [39, 25]),
    "pos_minus_one": (3, 32, 2, 2, 16, 8, 0, [-1, 31, -1]),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_dense_split_combine_matches_reference(name):
    B, T, K, G, hd, split, window, pos = SPLIT_CASES[name]
    q, k, v = _dense_case(B, T, K, G, hd, seed=len(name) + 40)
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jax_decode_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        block_kv=16, window=window))
    got = da_mod.decode_attn_split_plain(
        *(torch.from_numpy(a) for a in (q, k, v, pos)), split=split,
        window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dead = pos < 0            # no live split: exact zeros, as the kernel
    assert np.array_equal(got[dead], np.zeros_like(got[dead]))
    assert not np.signbit(got[dead]).any()


# the paged kernel's split-and-combine math: (B, K, G, hd, P, blk, nb,
# split_pages, window, pos, table). The tiny cases of PAGED_CASES in splits
# of two pages; tables with sentinels and negative entries past each row's
# pages; rows at pos -1; a window whose edge cuts a split; a row longer than
# 8 splits.
PAGED_SPLIT_CASES = dict(
    {f"paged_{name}": (B, K, G, hd, P, blk, nb, 2, window, pos,
                       "sentinel" if sentinel else "plain")
     for name, (B, K, G, hd, P, blk, nb, window, pos, sentinel)
     in PAGED_CASES.items()},
    sentinel_and_negative=(3, 2, 2, 16, 20, 4, 5, 2, 0, [3, 9, 17],
                           "negative"),
    pos_minus_one=(3, 2, 2, 16, 16, 4, 4, 2, 0, [-1, 11, -1], "sentinel"),
    window_cuts_a_split=(2, 2, 2, 16, 16, 4, 6, 2, 5, [13, 21], "sentinel"),
    row_longer_than_8_splits=(1, 2, 2, 16, 24, 4, 20, 2, 0, [77],
                              "sentinel"),
)


@pytest.mark.parametrize("name", sorted(PAGED_SPLIT_CASES))
def test_paged_split_combine_matches_reference(name):
    B, K, G, hd, P, blk, nb, pages, window, pos, table = PAGED_SPLIT_CASES[name]
    q, pk, pv, tbl, pos = _paged_case(B, K, G, hd, P, blk, nb, seed=len(name),
                                      pos=pos, sentinel=table != "plain")
    if table == "negative":              # unmapped entries below 0 clamp too
        for b in range(B):
            tbl[b, pos[b] // blk + 1::2] = -1 - b
    want = _jax_paged(q, pk, pv, tbl, pos, window)
    got = da_mod.paged_decode_attn_split_plain(
        *(torch.from_numpy(a) for a in (q, pk, pv, tbl, pos)),
        split_pages=pages, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dead = pos < 0            # no live split: exact zeros, as the kernel
    assert np.array_equal(got[dead], np.zeros_like(got[dead]))
    assert not np.signbit(got[dead]).any()


# the int8 paged kernel's split-and-combine math: (B, K, G, hd, P, blk, nb,
# split_pages, window, pos) against the JAX int8 op; splits of 1, 2 and 4
# pages, a window whose edge cuts a split, rows at pos -1, a row longer
# than 8 splits
QUANT_SPLIT_CASES = {
    "granite_heads_1_page": (3, 8, 4, 128, 12, 16, 4, 1, 0, [0, 16, 40]),
    "two_pages": (3, 2, 2, 32, 16, 8, 4, 2, 0, None),
    "four_pages": (2, 2, 2, 32, 24, 8, 8, 4, 0, [63, 20]),
    "g1_window": (3, 2, 1, 32, 16, 8, 4, 2, 12, None),
    "window_cuts_a_split": (2, 2, 2, 16, 16, 4, 6, 2, 5, [13, 21]),
    "pos_minus_one": (3, 2, 2, 16, 16, 4, 4, 2, 0, [-1, 11, -1]),
    "row_longer_than_8_splits": (1, 2, 2, 16, 24, 4, 20, 2, 0, [77]),
}


@pytest.mark.parametrize("name", sorted(QUANT_SPLIT_CASES))
def test_paged_quant_split_combine_matches_reference(name):
    B, K, G, hd, P, blk, nb, pages, window, pos = QUANT_SPLIT_CASES[name]
    q, pk, ks, pv, vs, tbl, pos = _quant_case(B, K, G, hd, P, blk, nb,
                                              seed=len(name), pos=pos,
                                              sentinel=True)
    j = [jnp.asarray(a) for a in (q, pk, ks, pv, vs, tbl, pos)]
    want = np.asarray(jax_decode_attn(j[0], j[1], j[3], j[6], block_tbl=j[5],
                                      window=window, k_scale=j[2],
                                      v_scale=j[4]))
    got = da_mod.paged_decode_attn_quant_split_plain(
        *(torch.from_numpy(a) for a in (q, pk, ks, pv, vs, tbl, pos)),
        split_pages=pages, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    dead = pos < 0            # no live split: exact zeros, as the kernel
    assert np.array_equal(got[dead], np.zeros_like(got[dead]))
    assert not np.signbit(got[dead]).any()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("blk", [64, 256, 512])
def test_long_pages_split_as_the_wrapper_splits_them(blk, quant):
    """Pages of 64, 256 and 512 tokens: the wrapper takes fewer pages per
    split than its tuned count (one page of 512 is one split), and that
    split-and-combine math matches the JAX op over bf16-layout and int8
    pools."""
    tuned = da_mod.PAGED_QUANT_SPLIT_PAGES if quant else da_mod.PAGED_SPLIT_PAGES
    pages = da_mod.split_pages(tuned, blk, "test")
    assert pages == min(tuned, da_mod.MAX_SPLIT // blk)
    assert pages * blk <= da_mod.MAX_SPLIT
    nb, P = 3, 11
    pos = [3 * blk - 1, blk, -1]
    if quant:
        q, pk, ks, pv, vs, tbl, pos = _quant_case(3, 2, 2, 16, P, blk, nb,
                                                  seed=blk, pos=pos,
                                                  sentinel=True)
        j = [jnp.asarray(a) for a in (q, pk, ks, pv, vs, tbl, pos)]
        want = np.asarray(jax_decode_attn(j[0], j[1], j[3], j[6],
                                          block_tbl=j[5], k_scale=j[2],
                                          v_scale=j[4]))
        got = da_mod.paged_decode_attn_quant_split_plain(
            *(torch.from_numpy(a) for a in (q, pk, ks, pv, vs, tbl, pos)),
            split_pages=pages).numpy()
    else:
        q, pk, pv, tbl, pos = _paged_case(3, 2, 2, 16, P, blk, nb, seed=blk,
                                          pos=pos, sentinel=True)
        want = _jax_paged(q, pk, pv, tbl, pos, 0)
        got = da_mod.paged_decode_attn_split_plain(
            *(torch.from_numpy(a) for a in (q, pk, pv, tbl, pos)),
            split_pages=pages).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[2].any()              # the row at pos -1


def test_paged_workspace_grows_and_is_reused():
    """The paged kernel's scratch: reused while a call fits it, grown (never
    shrunk) when one does not, the tickets zeroed only then."""
    da_mod._workspace.pop(torch.device("cpu"), None)
    try:
        a = da_mod._paged_workspace(torch.device("cpu"), 64, 8, 4)
        assert [t.numel() for t in a] == [64, 8, 4] and not a[2].any()
        assert all(x is y for x, y in zip(
            da_mod._paged_workspace(torch.device("cpu"), 32, 8, 2), a))
        b = da_mod._paged_workspace(torch.device("cpu"), 16, 20, 2)
        assert [t.numel() for t in b] == [64, 20, 4] and not b[2].any()
        assert a[1] is not b[1]
    finally:
        da_mod._workspace.pop(torch.device("cpu"), None)


def test_kernels_export_the_reference_public_names():
    public = {n for n in dir(jax_kernels) if not n.startswith("_")
              and callable(getattr(jax_kernels, n))}
    assert public == {"sgmv", "sgmv_ref", "ragged_linear",
                      "ragged_linear_ref", "decode_attn", "decode_attn_ref",
                      "flash_attn", "flash_attn_ref"}
    for name in public:
        assert callable(getattr(port_kernels, name)), name
    assert port_kernels.decode_attn is port_da.decode_attn


# int8 pools: the paged cases, and one with G = 1 (a KV head per query head)
QUANT_CASES = dict(PAGED_CASES, g1_window=(3, 2, 1, 32, 16, 8, 4, 12, None,
                                           True))


def _quant_case(B, K, G, hd, P, blk, nb, seed, pos=None, sentinel=False):
    """As ``_paged_case``, with int8 pools drawn over the full [-127, 127]
    range and positive f32 per-head scales [P, blk, K, 1]."""
    q, _, _, tbl, pos = _paged_case(B, K, G, hd, P, blk, nb, seed, pos,
                                    sentinel)
    rng = np.random.default_rng(seed + 1000)
    pk, pv = (rng.integers(-127, 128, (P, blk, K, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, (P, blk, K, 1)).astype(np.float32)
              for _ in range(2))
    return q, pk, ks, pv, vs, tbl, pos


@pytest.mark.parametrize("name", sorted(QUANT_CASES))
def test_paged_decode_attn_quant_matches_reference(name):
    """The int8 plain version against JAX's stream twin, and the op
    (``decode_attn`` with scales) against JAX's op on the CPU."""
    B, K, G, hd, P, blk, nb, window, pos, sentinel = QUANT_CASES[name]
    q, pk, ks, pv, vs, tbl, pos = _quant_case(B, K, G, hd, P, blk, nb,
                                              seed=len(name), pos=pos,
                                              sentinel=sentinel)
    j = [jnp.asarray(a) for a in (q, pk, ks, pv, vs, tbl, pos)]
    t = [torch.from_numpy(a) for a in (q, pk, ks, pv, vs, tbl, pos)]
    want = np.asarray(jax_quant_stream(*j, window=window))
    got = port_da.paged_decode_attn_quant_plain(*t, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_op = np.asarray(jax_decode_attn(j[0], j[1], j[3], j[6],
                                         block_tbl=j[5], window=window,
                                         k_scale=j[2], v_scale=j[4]))
    got_op = port_da.decode_attn(t[0], t[1], t[3], t[6], block_tbl=t[5],
                                 window=window, k_scale=t[2], v_scale=t[4])
    np.testing.assert_allclose(got_op.numpy(), want_op, **TOL)


@pytest.mark.parametrize("window", [0, 12])
def test_decode_attn_ref_with_scales_matches_reference_ref(window):
    q, pk, ks, pv, vs, tbl, pos = _quant_case(3, 2, 2, 32, 16, 8, 4, seed=4,
                                              sentinel=True)
    want = np.asarray(jax_decode_ref(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pos),
        window=window, block_tbl=jnp.asarray(tbl), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)))
    t = [torch.from_numpy(a) for a in (q, pk, ks, pv, vs, tbl, pos)]
    got = port_da.decode_attn_ref(t[0], t[1], t[3], t[6], window=window,
                                  block_tbl=t[5], k_scale=t[2], v_scale=t[4])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_quant_matches_oracle():
    """The blocked int8 online softmax equals the full softmax over the
    dequantized pages (port alone)."""
    q, pk, ks, pv, vs, tbl, pos = _quant_case(4, 2, 4, 64, 20, 8, 5, seed=9,
                                              sentinel=True)
    t = [torch.from_numpy(a) for a in (q, pk, ks, pv, vs, tbl, pos)]
    got = port_da.paged_decode_attn_quant_plain(*t, window=9)
    want = port_da.decode_attn_ref(t[0], t[1], t[3], t[6], window=9,
                                   block_tbl=t[5], k_scale=t[2],
                                   v_scale=t[4])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_head_matches_reference_bitwise(dtype):
    """int8 entries and scales equal the JAX quantizer's bit for bit: random
    heads, an all-zero head (the 1e-8 scale floor) and a head whose scale is
    exactly 1, so that x/scale lands on halves (round half to even)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 3, 2, 32)).astype(np.float32) * 4
    x[0, 0, 0] = 0.0
    x[1, 1, 1, :8] = [127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    x[1, 1, 1, 8:] = 0.25
    jx = jnp.asarray(x, dtype)
    xt = convert.tensor_from_numpy(np.asarray(jx), "cpu")
    jq, js = jax_quantize_head(jx)
    q, s = quantize_head(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.asarray(jq)[1, 1, 1, :8].tolist() == [127, 0, 2, 2, 0, -2,
                                                    126, -4]


def _sgmv_case(T, din, r, dout, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, din)).astype(np.float32)
    A = (rng.standard_normal((n, din, r)) / np.sqrt(din)).astype(np.float32)
    B = rng.standard_normal((n, r, dout)).astype(np.float32)
    return x, A, B


# (T, din, r, dout, n, block_t, ids): dead (-1) and out-of-range ids in both
# the decode (block_t = 1) and compacted-prefill (block_t = S) forms
SGMV_CASES = {
    "decode": (6, 64, 4, 48, 3, 1, [0, 2, -1, 1, 5, 0]),
    "decode_rank8": (5, 256, 8, 128, 4, 1, [3, 3, -1, 9, 0]),
    "prefill": (24, 64, 4, 32, 3, 8, [1, -1, 7]),
    "prefill_one_block": (16, 128, 8, 64, 2, 16, [1]),
}


@pytest.mark.parametrize("name", sorted(SGMV_CASES))
def test_sgmv_matches_reference(name):
    T, din, r, dout, n, block_t, ids = SGMV_CASES[name]
    x, A, B = _sgmv_case(T, din, r, dout, n, seed=len(name))
    ids = np.asarray(ids, np.int32)
    want = np.asarray(jax_sgmv(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(ids), block_t=block_t, scale=2.0))
    got = port_sgmv.sgmv(torch.from_numpy(x), torch.from_numpy(A),
                         torch.from_numpy(B), torch.from_numpy(ids),
                         block_t=block_t, scale=2.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dead = np.repeat(ids < 0, block_t)
    assert not got.numpy()[dead].any(), "dead blocks must be exact zeros"


@pytest.mark.parametrize("block_t", [1, 8])
def test_sgmv_ref_matches_reference_ref(block_t):
    x, A, B = _sgmv_case(16, 64, 4, 32, 3, seed=5)
    ids = np.array([2, -1, 0, 4, 1, 1, -1, 0, 2, 2, 0, 1, 3, -1, 0, 1],
                   np.int32)[:16 // block_t]
    want = np.asarray(jax_sgmv_ref(jnp.asarray(x), jnp.asarray(A),
                                   jnp.asarray(B), jnp.asarray(ids),
                                   block_t=block_t, scale=0.5))
    got = port_sgmv.sgmv_ref(torch.from_numpy(x), torch.from_numpy(A),
                             torch.from_numpy(B), torch.from_numpy(ids),
                             block_t=block_t, scale=0.5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (T, din, r, dout, n, block_t, ids): shapes the JAX op pads and the port
# takes as they are. T no multiple of block_t (the last block short), fewer
# ids than blocks (the blocks past them dead), the JAX default block_t
# (None here: one block of 128 holds all T rows).
SGMV_RAGGED_CASES = {
    "t6_block4_ids_0_1": (6, 16, 2, 8, 2, 4, [0, 1]),
    "t6_block1_one_id": (6, 16, 2, 8, 2, 1, [1]),
    "default_block_t": (6, 16, 2, 8, 2, None, [1]),
    "default_block_t_dead": (20, 32, 4, 16, 3, None, [-1]),
    "t7_block3_last_short": (7, 32, 4, 16, 3, 3, [2, -1, 0]),
    "t9_block4_two_of_three_ids": (9, 32, 8, 24, 3, 4, [5, 1]),
    "no_ids": (5, 16, 2, 8, 2, 2, []),
}


@pytest.mark.parametrize("name", sorted(SGMV_RAGGED_CASES))
def test_sgmv_ragged_shapes_match_reference(name):
    T, din, r, dout, n, block_t, ids = SGMV_RAGGED_CASES[name]
    x, A, B = _sgmv_case(T, din, r, dout, n, seed=len(name) + 7)
    ids = np.asarray(ids, np.int32)
    kw = dict(scale=0.5) if block_t is None else dict(block_t=block_t,
                                                      scale=0.5)
    want = np.asarray(jax_sgmv(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(ids), **kw))
    got = port_sgmv.sgmv(*(torch.from_numpy(a) for a in (x, A, B, ids)),
                         **kw).numpy()
    assert got.shape == want.shape == (T, dout)
    np.testing.assert_allclose(got, want, **TOL)
    bt = kw.get("block_t", 128)
    live = np.zeros(T, bool)
    for i, a in enumerate(ids):
        live[i * bt:(i + 1) * bt] = a >= 0
    assert not got[~live].any(), "dead and id-less blocks must be exact zeros"


def test_sgmv_strided_client_axis():
    """Layer-major views of a bank (strided client axis) give the same
    result as contiguous weights."""
    x, A, B = _sgmv_case(4, 32, 4, 16, 3, seed=2)
    bankA = torch.from_numpy(np.stack([A, A * 2]))        # [L=2, n, din, r]
    bankB = torch.from_numpy(np.stack([B, B * 2]))
    ids = torch.tensor([2, 0, -1, 1], dtype=torch.int32)
    strided = port_sgmv.sgmv(torch.from_numpy(x), bankA.transpose(0, 1)[:, 1],
                             bankB.transpose(0, 1)[:, 1], ids, block_t=1)
    dense = port_sgmv.sgmv(torch.from_numpy(x), bankA[1].contiguous(),
                           bankB[1].contiguous(), ids, block_t=1)
    np.testing.assert_array_equal(strided.numpy(), dense.numpy())


def test_cpu_tensors_never_launch():
    """A CPU tensor runs the plain version: the launch counts stay put."""
    before = (port_sgmv.sgmv_cuda.launches,
              port_da.paged_decode_attn_cuda.launches,
              port_da.paged_decode_attn_quant_cuda.launches,
              port_da.decode_attn_cuda.launches)
    x, A, B = _sgmv_case(2, 16, 2, 8, 2, seed=1)
    port_sgmv.sgmv(torch.from_numpy(x), torch.from_numpy(A),
                   torch.from_numpy(B), torch.tensor([0, 1], dtype=torch.int32),
                   block_t=1)
    q, pk, pv, tbl, pos = _paged_case(2, 1, 2, 16, 8, 4, 2, seed=1)
    port_da.decode_attn(*(torch.from_numpy(a) for a in (q, pk, pv, pos)),
                        block_tbl=torch.from_numpy(tbl))
    q, pk, ks, pv, vs, tbl, pos = _quant_case(2, 1, 2, 16, 8, 4, 2, seed=1)
    port_da.decode_attn(*(torch.from_numpy(a) for a in (q, pk, pv, pos)),
                        block_tbl=torch.from_numpy(tbl),
                        k_scale=torch.from_numpy(ks),
                        v_scale=torch.from_numpy(vs))
    q, k, v = _dense_case(2, 12, 1, 2, 16, seed=1)
    port_da.decode_attn(*(torch.from_numpy(a) for a in (q, k, v)),
                        torch.tensor([11, -1], dtype=torch.int32))
    assert (port_sgmv.sgmv_cuda.launches,
            port_da.paged_decode_attn_cuda.launches,
            port_da.paged_decode_attn_quant_cuda.launches,
            port_da.decode_attn_cuda.launches) == before


def test_bad_shapes_raise():
    q, pk, ks, pv, vs, tbl, pos = (torch.from_numpy(a) for a in _quant_case(
        2, 1, 2, 16, 8, 4, 2, seed=1))
    with pytest.raises(ValueError, match="both scale pools"):
        port_da.decode_attn(q, pk, pv, pos, block_tbl=tbl, k_scale=ks)
    with pytest.raises(ValueError, match="scale pools"):
        port_da.decode_attn(q, pk, pv, pos, block_tbl=tbl, k_scale=ks[..., 0],
                            v_scale=vs[..., 0])
    # sgmv takes what the JAX op takes (T no multiple of block_t: the last
    # block short), and refuses more ids than blocks, as the JAX op does
    x, A, B = _sgmv_case(6, 16, 2, 8, 2, seed=1)
    ids = np.array([0, 1], np.int32)
    want = np.asarray(jax_sgmv(jnp.asarray(x), jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(ids), block_t=4))
    got = port_sgmv.sgmv(*(torch.from_numpy(a) for a in (x, A, B, ids)),
                         block_t=4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="at most 2 ids"):
        port_sgmv.sgmv(torch.from_numpy(x), torch.from_numpy(A),
                       torch.from_numpy(B),
                       torch.tensor([0, 1, 0], dtype=torch.int32), block_t=4)


def test_quant_wrapper_refuses_what_the_kernel_does_not_take():
    """The int8 launch wrapper checks before it builds or launches: int8
    pools, f32 scales, fp32/bf16 q, one CUDA device (a CPU tensor handed
    to it raises instead of running anywhere)."""
    q, pk, ks, pv, vs, tbl, pos = (torch.from_numpy(a) for a in _quant_case(
        2, 1, 2, 16, 8, 4, 2, seed=1))
    launch = port_da.paged_decode_attn_quant_cuda
    with pytest.raises(TypeError, match="pools must be int8"):
        launch(q, pk.float(), ks, pv, vs, tbl, pos)
    with pytest.raises(TypeError, match="scales must be float32"):
        launch(q, pk, ks.double(), pv, vs.double(), tbl, pos)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(q.half(), pk, ks, pv, vs, tbl, pos)
    with pytest.raises(ValueError, match="one CUDA device"):
        launch(q, pk, ks, pv, vs, tbl, pos)
    assert launch.launches == 0


def test_paged_wrapper_refuses_what_the_kernel_does_not_take():
    """The paged launch wrapper checks before it builds or launches: rows
    of 16-byte multiples up to the kernel's hd, one fp32/bf16 dtype, one
    CUDA device (a CPU tensor handed to it raises instead of running
    anywhere), splits within the kernel's length."""
    q, pk, pv, tbl, pos = (torch.from_numpy(a) for a in _paged_case(
        2, 1, 2, 16, 8, 4, 2, seed=1))
    launch = port_da.paged_decode_attn_cuda
    with pytest.raises(ValueError, match="multiple of 4 up to"):
        launch(q[..., :6], pk[..., :6], pv[..., :6], tbl, pos)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(q, pk.bfloat16(), pv, tbl, pos)
    with pytest.raises(ValueError, match="one CUDA device"):
        launch(q, pk, pv, tbl, pos)
    blk = da_mod.MAX_SPLIT + 1            # a page longer than any split
    with pytest.raises(ValueError, match="pass the kernel's 512"):
        launch(q, *(torch.zeros(8, blk, 1, 16) for _ in range(2)), tbl, pos)
    assert launch.launches == 0


def test_dense_wrapper_refuses_what_the_kernel_does_not_take():
    """The dense launch wrapper checks before it builds or launches:
    matching shapes, one fp32/bf16 dtype, one CUDA device (a CPU tensor
    handed to it raises instead of running anywhere); int8 scales need the
    paged layout."""
    q, k, v = (torch.from_numpy(a) for a in _dense_case(2, 12, 1, 2, 16, 1))
    pos = torch.tensor([11, 3], dtype=torch.int32)
    launch = port_da.decode_attn_cuda
    with pytest.raises(ValueError, match="do not match"):
        launch(q, k[:, :, :, :8], v, pos)
    with pytest.raises(ValueError, match="needs 2 rows"):
        launch(q, k, v, pos[:1])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(q, k.bfloat16(), v, pos)
    with pytest.raises(ValueError, match="one CUDA device"):
        launch(q, k, v, pos)
    with pytest.raises(ValueError, match="multiple of 4 up to"):
        launch(q[..., :6], k[..., :6], v[..., :6], pos)   # rows of 24 bytes
    with pytest.raises(ValueError, match="multiple of 8 up to"):
        launch(torch.zeros(2, 1, 2, 264, dtype=torch.bfloat16),
               *(torch.zeros(2, 12, 1, 264, dtype=torch.bfloat16)
                 for _ in range(2)), pos)                 # past the kernel's hd
    with pytest.raises(ValueError, match="paged layout"):
        port_da.decode_attn(q, k, v, pos, k_scale=k[..., :1],
                            v_scale=v[..., :1])
    assert launch.launches == 0
