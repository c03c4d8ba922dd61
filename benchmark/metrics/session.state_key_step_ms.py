"""Session: the median host-clock ms of a step right after a zoom key,
which drops the lookahead frame, so the step renders and waits for its
own frame (the traced run's key steps, after its profile)."""

import statistics


def read(rec):
    ms = rec.get("key_steps_ms")
    if rec.get("driver") != "session" or not ms:
        return None
    return statistics.median(ms)
