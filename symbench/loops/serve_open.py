"""The open serving loop (``"loop": "serve_open"``): requests are submitted
at their due times whatever the engine is doing (arrivals from the mix's
``arrivals``); the traffic runs ``fill_seconds`` before the window opens,
and the window's requests are those due in it."""
import time

from bench import serve


def drive(lp, items, mix, seconds):
    """Fill, then tick until ``seconds`` past the window's start; returns
    (the window's start, the engine's counters there)."""
    eng, st = lp.eng, lp.eng.stats
    t_traffic = time.perf_counter()
    t_start = t_traffic + mix["fill_seconds"]
    started, snap0 = False, None
    while True:
        now = time.perf_counter()
        if not started and now >= t_start:
            started, t_start, snap0 = True, now, dict(st)
            lp.watch_until = now + 0.7 * seconds
        if started and now >= t_start + seconds:
            return t_start, snap0
        while lp.next < len(items) and t_traffic + items[lp.next].due <= now:
            lp.submit(items[lp.next], t_traffic + items[lp.next].due)
            lp.next += 1
        if lp.next >= len(items):
            raise RuntimeError("the arrival schedule ran out")
        if not eng.pending():
            time.sleep(max(0.0, min(0.002, t_traffic + items[lp.next].due
                                    - time.perf_counter())))
            continue
        if started:
            lp.maybe_profile(now, t_start, t_start + seconds)
        lp.tick(started)


def due_in(lp, t_start, t_end):
    return [(r, d) for r, d in lp.tracked if t_start <= d < t_end]


def run(arch, mix, cell, seed, seconds, trace, device, log, **kw):
    return serve.run(arch, mix, cell, seed, seconds, trace, device, log,
                     drive, due_in, **kw)


def readings(*args):
    return serve.readings(run, *args)
