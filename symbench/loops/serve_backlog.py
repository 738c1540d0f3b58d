"""The backlog serving loop (``"loop": "serve_backlog"``): a queue larger
than the window can finish (``backlog``) is handed over as slots free, at
most ``admit_per_tick`` waiting at a time. The window opens once the engine
has been full (every slot taken, or a submitted request left waiting) and
retirements have begun; its requests are those in flight in it."""
import time

from bench import serve


def drive(lp, items, mix, seconds):
    """Ramp to full, then tick until ``seconds`` past the window's start;
    returns (the window's start, the engine's counters there)."""
    st = lp.eng.stats
    cap = mix["admit_per_tick"]
    full = mix["tenants"] * mix["slots_per_tenant"]
    t_start, started, retired, was_full = None, False, False, False
    t_fill = time.perf_counter()
    while True:
        now = time.perf_counter()
        if not started and was_full and retired:
            started, t_start, snap0 = True, now, dict(st)
            lp.watch_until = now + 0.7 * seconds
        if started and now >= t_start + seconds:
            return t_start, snap0
        if not started and now - t_fill > mix["max_fill_seconds"]:
            raise RuntimeError("the backlog never filled every slot")
        room = min(cap - len(lp.pending), full - len(lp.live)
                   - len(lp.pending))
        for _ in range(max(0, room)):
            if lp.next >= len(items):
                raise RuntimeError("the backlog ran out")
            lp.submit(items[lp.next], now)
            lp.next += 1
        if started:
            lp.maybe_profile(now, t_start, t_start + seconds)
        lp.tick(started)
        # full: every slot taken, or the engine left a request waiting
        # (slots or pages of its tenant are all held)
        was_full = was_full or len(lp.live) == full or bool(lp.pending)
        retired = retired or lp.retired


def due_in(lp, t_start, t_end):
    return [(r, d) for r, d in lp.tracked if r.admit_t and r.admit_t < t_end
            and (not r.finish_t or r.finish_t >= t_start)]


def run(arch, mix, cell, seed, seconds, trace, device, log, **kw):
    return serve.run(arch, mix, cell, seed, seconds, trace, device, log,
                     drive, due_in, **kw)


def readings(*args):
    return serve.readings(run, *args)
