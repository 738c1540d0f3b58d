"""The traffic generator: a run's inputs follow from its seed alone, and
every seed serves the same multiset of sizes."""
import numpy as np
import torch

import tiny
from bench import traffic


def _key(items):
    return [(i.due, i.tenant, i.max_new, i.prompt.tobytes()) for i in items]


def test_serving_items_are_deterministic_in_the_seed():
    mix = tiny.serve_mix("serve_open")
    a = traffic.serving_items(mix, 4000000001, 5.0, 256, mix["tenants"])
    b = traffic.serving_items(mix, 4000000001, 5.0, 256, mix["tenants"])
    c = traffic.serving_items(mix, 4000000002, 5.0, 256, mix["tenants"])
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


def test_every_seed_serves_the_same_sizes():
    for name in ("serve_open", "serve_backlog"):
        mix = tiny.serve_mix(name)
        a = traffic.serving_items(mix, 11, 5.0, 256, mix["tenants"])
        b = traffic.serving_items(mix, 2 ** 31 + 5, 5.0, 256, mix["tenants"])
        assert len(a) == len(b)
        for f in (lambda i: i.prompt.shape[1], lambda i: i.max_new):
            assert sorted(map(f, a)) == sorted(map(f, b))
    # an open loop's window requests: one multiset of sizes and of gaps
    mix = tiny.serve_mix("serve_open")
    fill = mix["fill_seconds"]
    win = []
    for seed in (11, 2 ** 31 + 5):
        items = traffic.serving_items(mix, seed, 5.0, 256, mix["tenants"])
        w = [i for i in items if i.due > fill]
        win.append((sorted(i.prompt.shape[1] for i in w),
                    sorted(i.max_new for i in w),
                    np.sort(np.diff([fill] + [i.due for i in w]))))
    assert win[0][0] == win[1][0] and win[0][1] == win[1][1]
    assert np.allclose(win[0][2], win[1][2])


def test_lengths_stay_in_their_range():
    mix = tiny.serve_mix("serve_open")
    items = traffic.serving_items(mix, 3, 5.0, 256, mix["tenants"])
    p = [i.prompt.shape[1] for i in items]
    o = [i.max_new for i in items]
    assert min(p) >= mix["prompt"]["min"] and max(p) <= mix["prompt"]["max"]
    assert min(o) >= mix["output"]["min"] and max(o) <= mix["output"]["max"]
    assert all(0 <= i.tenant < mix["tenants"] for i in items)
    assert all(i.prompt.min() >= 0 and i.prompt.max() < 256 for i in items)


def test_job_batches_are_deterministic_in_seed_job_and_step():
    s = traffic.JobStream(4000000001, 3, 2, 16, 256, "cpu")
    a, b = s.batch(5), s.batch(5)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    other = traffic.JobStream(4000000001, 4, 2, 16, 256, "cpu").batch(5)
    assert not torch.equal(a["tokens"], other["tokens"])
    assert not torch.equal(a["tokens"], s.batch(6)["tokens"])
