"""Still: the median ms of ``DynamicDiskSystem.advance`` at t = 0 (the
background kernel, entities, stats and compose), from a synchronised
start to a synchronised end, over the traced run's timed stills (the
driver's timers around the call, after the profiled stills)."""

import statistics


def read(rec):
    ms = (rec.get("layers") or {}).get("lifecycle")
    if rec.get("driver") != "still" or not ms:
        return None
    return statistics.median(ms)
