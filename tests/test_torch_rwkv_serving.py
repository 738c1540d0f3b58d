"""PyTorch port vs the JAX reference: the RWKV6 family behind the serving
engine, on the CPU.

On ``tiny(RWKV)`` fp32, weights and banks drawn by numpy
(``test_torch_rwkv.numpy_params`` / ``numpy_bank``) and handed to both
packages:

* the port's engine against the JAX engine tick by tick, both
  ``debug=True`` behind a ``PlacementRouter`` whose slot holds two
  requests' state (so admission waits), telemetry on, LoRA (q as r, v,
  cm_k) and IA3 (k, v; ``down`` names nothing): admissions, slots,
  ``stats``, the router ledgers and the conservation audit equal after
  every tick, slots reused; greedy streams identical; the events' kinds,
  ticks and tenants identical (JAX's ``compile`` events aside);
* a prefix bank serves the bare base (no layer reads prefix K/V, as in
  JAX's RWKV): its streams those of another prefix bank and of a LoRA
  bank with zero B;
* ``page_block`` and ``kv_quant`` fall back to the dense layout, as in
  JAX: no pages, no int8, no compacted decode, prompts unpadded;
* the refusals JAX has, in its words: mixed banks, ``compact_decode=True``,
  ``ragged_prefill=True``, ``prefix_cache=True``, ``admit_bank``; a prompt
  past the recurrence's chunk contract fails at its prefill;
* within the port: every stream equals its run alone on a fresh engine
  (a reused slot starts from zero state), and a killed engine resumed from
  ``engine_state`` serves the uninterrupted streams bit for bit;
* the serve CLI on rwkv6-7b reduced.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import RWKV, ServeConfig
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.obs import Obs as JaxObs
from repro.serving import kvcache as jax_kvcache
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.launch import serve as port_serve
from repro_torch.obs import Obs
from repro_torch.serving.engine import Request, ServingEngine
from conftest import tiny
from test_torch_dense_serving import serve_both
from test_torch_mixed_serving import _routers, port_acfg, port_scfg
from test_torch_model import port_config
from test_torch_rwkv import one_thread  # noqa: F401 (autouse)
from test_torch_rwkv import IA3, LORA, PREFIX, numpy_bank, numpy_params

C, MAX_SEQ = 3, 40


def make_engines(acfgs, np_banks, scfg, *, max_b=2, routers=(None, None),
                 obs=(None, None), only=None, **kw):
    """The JAX and the port engine over the same numpy base and banks,
    both ``debug=True``; ``kw`` goes to both. ``only="port"`` or
    ``"jax"`` builds that one alone (None in the other's place)."""
    cfg = tiny(RWKV)
    np_base = numpy_params(cfg, 11)
    caps = [jax.tree.leaves(b)[0].shape[0] for b in np_banks]
    jeng = peng = None
    if only != "port":
        jeng = JaxServingEngine(JaxEngineSpec(cfg=cfg, banks=tuple(
            JaxBankSpec(f"b{m}", a, k)
            for m, (a, k) in enumerate(zip(acfgs, caps))),
            serve=scfg, max_batch_per_client=max_b),
            jax.tree.map(jnp.asarray, np_base),
            [jax.tree.map(jnp.asarray, b) for b in np_banks],
            router=routers[0], debug=True, obs=obs[0], **kw)
    if only != "jax":
        pc = port_config(cfg)
        peng = ServingEngine(EngineSpec(cfg=pc, banks=tuple(
            BankSpec(f"b{m}", port_acfg(a), k)
            for m, (a, k) in enumerate(zip(acfgs, caps))),
            serve=port_scfg(scfg), max_batch_per_client=max_b),
            convert.params_from_numpy(pc, np_base, "cpu"),
            [convert.bank_from_numpy(port_acfg(a), b, "cpu")
             for a, b in zip(acfgs, np_banks)],
            device="cpu", router=routers[1], debug=True, obs=obs[1], **kw)
    return jeng, peng


def rwkv_work(vocab, seed=13):
    """Staggered 1-2 row requests of 4 or 6 tokens (unpadded prefills),
    two of a client in flight at once and later ones reusing freed
    slots."""
    rng = np.random.default_rng(seed)
    out = []
    for i, t in enumerate((0, 0, 1, 2, 3, 4, 6, 8)):
        out.append(dict(client_id=(0, 1, 2, 0, 0, 1, 2, 1)[i], arrive_tick=t,
                        prompt=rng.integers(0, vocab, (2 if i == 2 else 1,
                                                       (4, 6)[i % 2]))
                        .astype(np.int32),
                        max_new_tokens=(3, 6, 4)[i % 3]))
    return out


def _kinds(events):
    return [(e.kind, e.tick, e.tenant) for e in events
            if e.kind not in ("compile", "recompile")]


@pytest.mark.parametrize("acfg", [LORA, IA3], ids=["lora", "ia3"])
def test_engine_matches_reference_tick_by_tick(acfg):
    """Per-request admission on the dense layout (no ragged or compacted
    prefill, as JAX), router charges of the RWKV spec (a fixed state per
    slot, none per token) making admissions wait, slots reused, telemetry
    on."""
    cfg = tiny(RWKV)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ)
    routers = _routers(cfg, 2 * jax_kvcache.cache_bytes(cfg, MAX_SEQ, 1))
    obs = (JaxObs(), Obs())
    jeng, peng = make_engines((acfg,), [numpy_bank(cfg, acfg, C, 12)], scfg,
                              routers=routers, obs=obs)
    assert not (peng._paged or peng._ragged or peng._compact
                or peng._compact_prefill or peng._share_prefix)
    reqs = serve_both(jeng, peng, rwkv_work(cfg.vocab), routers)
    assert peng.stats["prefill_calls"] == peng.stats["admitted"] == 8
    assert peng.stats["peak_inflight"] == 2 and len(reqs) == 8
    assert _kinds(obs[1].drain_events()) == _kinds(obs[0].drain_events())


def test_prefix_bank_serves_the_bare_base():
    """No RWKV layer reads prefix K/V (JAX's behaviour, copied), so a
    prefix bank's clients are served the bare base: two prefix banks of
    different values and a LoRA bank whose B is zero (a delta of exact
    zeros) serve the same streams."""
    cfg = tiny(RWKV)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ)
    zero = numpy_bank(cfg, LORA, C, 23)
    for leaf in zero["layers"].values():
        leaf["B"][:] = 0.0
    streams = []
    for acfg, bank in ((PREFIX, numpy_bank(cfg, PREFIX, C, 21)),
                       (PREFIX, numpy_bank(cfg, PREFIX, C, 22)),
                       (LORA, zero)):
        _, eng = make_engines((acfg,), [bank], scfg, only="port")
        reqs = [Request(**w) for w in rwkv_work(cfg.vocab, seed=5)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        streams.append([r.generated for r in reqs])
    for other in streams[1:]:
        for a, b in zip(streams[0], other):
            np.testing.assert_array_equal(a, b)


def test_page_block_and_kv_quant_fall_back_to_dense():
    """Both engines drop ``page_block`` and ``kv_quant`` (nothing to page
    or quantize): the dense masked decode, prompts at their true length,
    and the port's streams those of the plain dense engine."""
    cfg = tiny(RWKV)
    bank = [numpy_bank(cfg, LORA, C, 12)]
    jeng, peng = make_engines((LORA,), bank, ServeConfig(
        n_clients=C, max_seq=MAX_SEQ, page_block=8, kv_quant=True))
    for eng in (jeng, peng):
        assert not (eng._paged or eng._quant or eng._compact)
        assert [eng._bucket(s) for s in (3, 9, 17)] == [3, 9, 17]
    assert sorted(peng.caches["layers"]) == ["cm_x", "tm_x", "wkv"]
    _, dense = make_engines((LORA,), bank, ServeConfig(n_clients=C,
                                                       max_seq=MAX_SEQ),
                            only="port")
    work = rwkv_work(cfg.vocab, seed=3)[:4]
    out = []
    for eng in (peng, dense):
        reqs = [Request(**w) for w in work]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out.append([r.generated for r in reqs])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_refusals_match_reference():
    """What JAX refuses on RWKV, refused by both in JAX's words: mixed
    banks (no pages), ``compact_decode=True``, ``ragged_prefill=True``,
    ``prefix_cache=True`` and ``admit_bank``; a 130-token prompt (over the
    128-step chunk, no multiple of it) fails at its prefill."""
    cfg = tiny(RWKV)
    scfg = ServeConfig(n_clients=C, max_seq=200, page_block=8)
    bank = numpy_bank(cfg, LORA, C, 12)
    for acfgs, banks, ekw, match in (
            ((LORA, IA3), [bank, numpy_bank(cfg, IA3, 2, 13)], {},
             "mixed-method serving banks require the paged KV layout"),
            ((LORA,), [bank], dict(compact_decode=True),
             "compact_decode requires the paged KV layout"),
            ((LORA,), [bank], dict(ragged_prefill=True),
             "attention families"),
            ((LORA,), [bank], dict(prefix_cache=True), "prefix_cache")):
        for only in ("jax", "port"):
            with pytest.raises(ValueError, match=match):
                make_engines(acfgs, banks, scfg, only=only, **ekw)
    jeng, peng = make_engines((LORA,), [bank], scfg)
    extra = numpy_bank(cfg, IA3, 1, 14)
    want = "dynamic bank admission requires the paged KV layout"
    with pytest.raises(ValueError, match=want):
        jeng.admit_bank(IA3, jax.tree.map(jnp.asarray, extra))
    with pytest.raises(ValueError, match=want):
        peng.admit_bank(port_acfg(IA3), convert.bank_from_numpy(
            port_acfg(IA3), extra, "cpu"))
    peng.submit(Request(0, np.zeros((1, 130), np.int32), 2))
    with pytest.raises(ValueError, match="seq 130 % chunk 128 != 0"):
        peng.service_tick()


def test_streams_equal_solo_runs_and_resume_bit_for_bit():
    """Within the port, one slot per client (every later request reuses a
    slot whose state was live): every stream equals its run alone on a
    fresh engine; a killed engine's ``engine_state`` (the ``layers``
    state tree) resumed by a fresh engine serves the uninterrupted
    streams bit for bit."""
    cfg = tiny(RWKV)
    bank = [numpy_bank(cfg, LORA, 2, 14)]
    scfg = ServeConfig(n_clients=2, max_seq=MAX_SEQ)
    rng = np.random.default_rng(0)
    work = [dict(client_id=c, prompt=rng.integers(0, cfg.vocab, (1, n))
                 .astype(np.int32), max_new_tokens=m, arrive_tick=t)
            for c, n, m, t in ((0, 5, 4, 0), (1, 6, 6, 1), (0, 5, 3, 2),
                               (0, 7, 5, 3))]

    def fresh():
        return make_engines((LORA,), bank, scfg, max_b=1, only="port")[1]

    whole = fresh()
    reqs = [Request(**w) for w in work]
    for r in reqs:
        whole.submit(r)
    whole.run()
    for w, r in zip(work, reqs):
        solo_eng = fresh()
        solo = Request(**dict(w, arrive_tick=0))
        solo_eng.submit(solo)
        solo_eng.run()
        np.testing.assert_array_equal(solo.generated, r.generated)
    killed = fresh()
    for w in work:
        killed.submit(Request(**w))
    for _ in range(4):
        killed.service_tick()
    state = killed.engine_state()
    assert sorted(state["caches"]["layers"]) == ["cm_x", "tm_x", "wkv"]
    resumed = fresh()
    resumed.load_engine_state(state)
    done = resumed.run() + killed.drain_done()
    got = {(r.client_id, r.prompt.tobytes()): r.generated for r in done}
    assert len(got) == len(reqs)
    for r in reqs:
        np.testing.assert_array_equal(
            got[(r.client_id, r.prompt.tobytes())], r.generated)


def test_serve_cli_serves_rwkv(capsys):
    """``--arch rwkv6-7b`` (reduced) on the CPU: ``--page-block`` and
    ``--kv-quant`` are dropped, so the layout line reports ``dense``."""
    done = port_serve.main(["--device", "cpu", "--arch", "rwkv6-7b",
                            "--clients", "2", "--requests", "3",
                            "--prompt-len", "6", "--max-new", "3",
                            "--stagger", "1", "--page-block", "8",
                            "--kv-quant"])
    out = capsys.readouterr().out
    assert "rwkv6-7b-smoke" in out and "kv=dense" in out
    assert "+int8" not in out
    assert len(done) == 3 and all(r.generated.shape == (2, 3) for r in done)
