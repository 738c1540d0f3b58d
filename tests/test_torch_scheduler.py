"""PyTorch port vs the JAX reference: the scheduler simulation (paper
§3.7, Tables 4/5), pure Python on the host, held EXACTLY (every float of
the result, not to a tolerance):

* ``core.scheduler.simulate`` against JAX's over a sweep of the three
  policies x ``backward`` x latency-sensitive mixes x 1-8 clients with
  mixed token counts, client-side times and iteration counts;
* ``ServingEngine.simulate_policy`` on a tiny engine's finished requests
  against JAX's on the same request records (every policy), and
  ``Request.latency_sensitive`` carried through ``engine_state``;
* the serve CLI prints the simulated timeline of its run.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import scheduler as jax_scheduler
from repro.serving.engine import Request as JaxRequest
from repro_torch.core import scheduler as port_scheduler
from repro_torch.serving.engine import Request
from test_torch_engine import _jax_engine, _port_engine, _system, _workload

MIXES = {"none": lambda i: False, "all": lambda i: True,
         "odd": lambda i: i % 2 == 1}


def _clients(mod, n, mix):
    rng = np.random.default_rng(100 + n)
    return [mod.ClientSpec(client_id=i,
                           n_tokens=int(rng.integers(1, 300)),
                           client_side_time=float(rng.uniform(1e-5, 2e-4)),
                           n_iterations=int(rng.integers(1, 5)),
                           latency_sensitive=MIXES[mix](i))
            for i in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("policy", ["lockstep", "nolockstep",
                                    "opportunistic"])
def test_simulate_equals_reference(policy, backward, mix, n):
    kw = dict(n_layers=3, policy=policy, exec_overhead=1e-4,
              per_token_cost=1e-6, wait_fraction=0.3, backward=backward)
    want = jax_scheduler.simulate(_clients(jax_scheduler, n, mix), **kw)
    got = port_scheduler.simulate(_clients(port_scheduler, n, mix), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()


@pytest.fixture(scope="module")
def finished():
    """A tiny port engine's finished requests (some not latency
    sensitive), and the JAX engine over the same system (built, not
    run)."""
    cfg, acfg, scfg, base, bank = _system()
    port = _port_engine(cfg, acfg, scfg, base, bank, "opportunistic")
    for i, w in enumerate(_workload(cfg.vocab)):
        port.submit(Request(**w, latency_sensitive=i % 3 != 1))
    done = port.run()
    jeng = _jax_engine(cfg, acfg, scfg, base, bank, "opportunistic")
    return port, jeng, done


@pytest.mark.parametrize("policy", [None, "lockstep", "nolockstep"])
def test_simulate_policy_equals_reference(finished, policy):
    """The same request records through both engines' ``simulate_policy``
    (None: the engine's own policy, opportunistic)."""
    port, jeng, done = finished
    assert len(done) == 7 and {r.latency_sensitive for r in done} == \
        {True, False}
    jreqs = [JaxRequest(client_id=r.client_id, prompt=r.prompt,
                        max_new_tokens=r.max_new_tokens,
                        latency_sensitive=r.latency_sensitive) for r in done]
    got = port.simulate_policy(done, policy=policy)
    want = jeng.simulate_policy(jreqs, policy=policy)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_latency_sensitive_rides_engine_state():
    """A request's flag is in its ``engine_state`` record and comes back
    with it, as JAX's does."""
    cfg, acfg, scfg, base, bank = _system()
    eng = _port_engine(cfg, acfg, scfg, base, bank, "opportunistic")
    for i, w in enumerate(_workload(cfg.vocab)[:3]):
        eng.submit(Request(**w, latency_sensitive=bool(i % 2)))
    eng.service_tick()
    state = eng.engine_state()
    back = _port_engine(cfg, acfg, scfg, base, bank, "opportunistic")
    back.load_engine_state(state)
    recs = [r for k in ("inflight", "waiting", "queue", "done")
            for r in state[k]]
    flags = sorted(r["latency_sensitive"] for r in recs)
    assert flags == [False, False, True]
    done = back.run()
    assert sorted(r.latency_sensitive for r in done) == flags


def test_serve_cli_prints_the_timeline(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--device", "cpu", "--clients", "2", "--requests", "3",
                       "--prompt-len", "4", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    line = [ln for ln in out if "policy timeline" in ln]
    assert len(line) == 1
    assert line[0].startswith("[serve] policy timeline (opportunistic): ")
    assert "throughput_tok_s" in line[0] and "makespan_s" in line[0]
    assert len(done) == 3
