"""Still: the median ms of ``Renderer.render`` (trace, shade, post and
the frame's copy to the host), from a synchronised start to a
synchronised end, over the traced run's timed stills (the driver's
timers around the call, after the profiled stills)."""

import statistics


def read(rec):
    ms = (rec.get("layers") or {}).get("render")
    if rec.get("driver") != "still" or not ms:
        return None
    return statistics.median(ms)
