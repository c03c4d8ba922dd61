"""Static still: the median ms of ``generate_disk_texture`` on a cache
miss (the 13 fields, their stats and the compose, left on the card),
from a synchronised start to a synchronised end, over the traced run's
timed stills (the driver's timers around the call, after the profiled
stills)."""

import statistics


def read(rec):
    ms = (rec.get("layers") or {}).get("generate")
    if rec.get("driver") != "still" or not ms:
        return None
    return statistics.median(ms)
