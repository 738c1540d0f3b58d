"""PyTorch port vs the JAX reference: cache sizing, the placement router,
and the engine's router-priced admission over int8 pages.

The JAX router prices latency with ``repro.common.hardware.V5E`` whatever
its slots say; the port's router takes its chip as an argument. So the port
is handed a ``Chip`` built from V5E's fields here, in the test only, and
both sides price alike: modes, slots and charges must be equal, and the
latency estimates equal to rtol 1e-12.
"""
import dataclasses

import numpy as np
import pytest

from repro.common.hardware import V5E
from repro.config import DENSE
from repro.configs import get_config as jax_get_config
from repro.serving import kvcache as jax_kvcache
from repro.serving.router import PlacementRouter as JaxRouter
from repro.serving.router import Slot as JaxSlot
from repro_torch.common.hardware import H100, Chip
from repro_torch.configs import get_config
from repro_torch.serving import kvcache
from repro_torch.serving.router import PlacementRouter, Slot
from conftest import tiny
from repro_torch.serving.engine import Request
from test_torch_engine import (_port_engine, _system, _workload,
                               serve_tick_by_tick)
from test_torch_model import port_config

REF_CHIP = Chip(**{f: getattr(V5E, f) for f in Chip.__dataclass_fields__})
CONFIGS = {"granite-3-8b": lambda: jax_get_config("granite-3-8b"),
           "tiny_fp32": lambda: tiny(DENSE),
           "tiny_bf16": lambda: tiny(DENSE, dtype="bfloat16")}


def test_h100_chip_is_the_cards_data_sheet():
    assert (H100.peak_flops_bf16, H100.hbm_bandwidth, H100.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("page_block", [0, 16])
def test_cache_bytes_match_reference(name, quant, page_block):
    cfg = CONFIGS[name]()
    pc = port_config(cfg)
    assert kvcache.make_cache_spec(pc, quant=quant) == \
        kvcache.CacheSpec(**dataclasses.asdict(
            jax_kvcache.make_cache_spec(cfg, quant=quant)))
    for seq, batch in ((1, 1), (17, 2), (100, 3), (4096, 1)):
        assert kvcache.cache_bytes(pc, seq, batch, quant=quant,
                                   page_block=page_block) == \
            jax_kvcache.cache_bytes(cfg, seq, batch, quant=quant,
                                    page_block=page_block)


def test_granite_int8_halves_the_bytes_per_token():
    """bf16 K/V of granite-3-8b: 163,840 B per token; int8 entries plus f32
    scales: 84,480 B (0.52x)."""
    cfg = get_config("granite-3-8b")
    assert kvcache.make_cache_spec(cfg).bytes_per_token == 163_840
    assert kvcache.make_cache_spec(cfg, quant=True).bytes_per_token == 84_480


@pytest.mark.parametrize("seq", [16, 4096, 200_000])
def test_decode_token_cost_matches_reference(seq):
    """The port prices the on-card placement only: the JAX ``gpu`` branch,
    infinite once the cache outgrows the chip (200K tokens on V5E)."""
    cfg = jax_get_config("granite-3-8b")
    want = jax_kvcache.decode_token_cost(cfg, seq, placement="gpu")
    assert want.transfer == 0.0
    assert kvcache.decode_token_cost(port_config(cfg), seq,
                                     chip=REF_CHIP) == want.compute


@pytest.mark.parametrize("seq", [1_000, 30_000, 60_000])
def test_fits_hbm_matches_reference(seq):
    cfg = jax_get_config("granite-3-8b")
    for batch in (1, 2):
        assert kvcache.fits_hbm(port_config(cfg), seq, batch,
                                chip=REF_CHIP) == \
            jax_kvcache.fits_hbm(cfg, seq, batch, chip=V5E)
    assert kvcache.fits_hbm(port_config(cfg), 60_000, 2)    # on the H100


# a sequence of (context, batch, alloc_tokens, quant) routes against two
# slots, then releases; contexts reach from a page to past what either slot
# holds, so both slots are chosen and routes are refused. The JAX router is
# given no host memory, so it too places on the card or refuses.
ROUTES = [(64, 1, 0, False), (4096, 2, 4096, True), (100_000, 1, 0, False),
          (15_000, 1, 15_008, True), (512, 4, 512, False),
          (250_000, 1, 0, True), (2_000_000, 1, 0, False),
          (9_000, 3, 9_008, True)]


def _routers(cfg):
    def slots(mk):
        return [mk(0, free_hbm=1e9), mk(1, free_hbm=3e9)]
    return (JaxRouter(cfg, slots(JaxSlot), host_free_bytes=0),
            PlacementRouter(port_config(cfg), slots(Slot), chip=REF_CHIP))


def _same_use(pr, jr):
    want = jr.utilization()
    assert pr.utilization() == {k: want[k] for k in
                                ("slots", "placements", "committed_bytes")}


def _same_placement(got, want):
    assert want.mode == "gpu"
    assert (got.slot_id, got.cache_bytes) == (want.slot_id, want.cache_bytes)
    np.testing.assert_allclose(got.est_s_per_token, want.est_s_per_token,
                               rtol=1e-12)


def test_route_matches_reference():
    cfg = jax_get_config("granite-3-8b")
    jr, pr = _routers(cfg)
    held = []
    for ctx, batch, alloc, quant in ROUTES:
        kw = dict(alloc_tokens=alloc, quant=quant)
        try:
            want = jr.route(ctx, batch, **kw)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                pr.route(ctx, batch, **kw)
            continue
        got = pr.route(ctx, batch, **kw)
        _same_placement(got, want)
        _same_use(pr, jr)
        held.append((want, got))
    assert {p.slot_id for _, p in held} == {0, 1}
    assert len(held) < len(ROUTES)
    for want, got in held[::2]:
        jr.release(want)
        pr.release(got)
        _same_use(pr, jr)
    with pytest.raises(RuntimeError, match="never committed"):
        pr.release(held[0][1])
    assert pr.conservation_errors() == []
    pr.slots[0].free_hbm -= 1e6                       # a leaked charge
    assert pr.conservation_errors()


def test_engine_with_router_matches_reference_tick_by_tick():
    """int8 pages behind a router whose budget holds about two requests'
    charges: the JAX engine (its router given no host memory, so nothing is
    placed off the card) and the port engine make the same placements,
    commit the same bytes and queue the same requests on every tick, and
    the router drains clean."""
    cfg, _, scfg, _, _ = _system()
    scfg = dataclasses.replace(scfg, kv_quant=True, pool_pages=0)
    budget = 2 * jax_kvcache.cache_bytes(cfg, 24, 2, quant=True)
    routers = (JaxRouter(cfg, [JaxSlot(0, free_hbm=budget)],
                         host_free_bytes=0),
               PlacementRouter(port_config(cfg), [Slot(0, free_hbm=budget)],
                               chip=REF_CHIP))
    work = [dict(w, arrive_tick=0) for w in _workload(cfg.vocab, seed=3)]
    queued = []

    def same_charges(jeng, peng, jidx, pidx):
        jp = {jidx[k]: p for k, p in jeng._placement.items() if p is not None}
        pp = {pidx[k]: p for k, p in peng._placement.items()}
        assert sorted(jp) == sorted(pp)
        for i, p in pp.items():
            _same_placement(p, jp[i])
        _same_use(peng.router, jeng.router)
        assert len(peng._waiting) == len(jeng._waiting)
        queued.append(len(peng._waiting))

    jeng, peng = serve_tick_by_tick("opportunistic", scfg, work, routers,
                                    each_tick=same_charges)
    assert max(queued) > 0, "the budget never made a request wait"
    assert peng.stats["peak_inflight"] == jeng.stats["peak_inflight"] < len(work)
    for eng in (jeng, peng):
        assert eng.router.conservation_errors() == []
        assert eng.router.utilization()["committed_bytes"] == 0


def test_engine_router_with_defaults_queues_on_the_card():
    """A router given nothing but its slot keeps every cache on the card:
    while the slot is full, requests wait instead of being placed
    elsewhere, and all are served once the charges come back."""
    cfg, acfg, scfg, base, bank = _system()
    scfg = dataclasses.replace(scfg, kv_quant=True, pool_pages=0)
    pc = port_config(cfg)
    budget = 2 * kvcache.cache_bytes(pc, 24, 2, quant=True)
    router = PlacementRouter(pc, [Slot(0, free_hbm=budget)])
    eng = _port_engine(cfg, acfg, scfg, base, bank, "opportunistic", router)
    work = [dict(w, arrive_tick=0) for w in _workload(cfg.vocab, seed=3)]
    for w in work:
        eng.submit(Request(**w))
    waited = 0
    while eng.service_tick():
        waited = max(waited, len(eng._waiting))
        assert router.slots[0].free_hbm >= 0
    assert len(eng.drain_done()) == len(work)
    assert waited > 0 and eng.stats["peak_inflight"] < len(work)
    assert router.conservation_errors() == []
    assert router.utilization()["committed_bytes"] == 0
