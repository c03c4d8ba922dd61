"""Session: the host's time enqueueing a step's frame, texture to
quantise, with the shade's wait for its trace inside (the span
``session.enqueue`` of the program's span table), the median ms over the
window's steps.

The table holds a sample for every step of the process, oldest first:
the warm steps, the window's (``steps_ms``), then the traced run's
profiled steps and key steps, which the window's median leaves out."""

import statistics


def read(rec):
    n = len(rec.get("steps_ms", ()))
    if rec.get("driver") != "session" or not n:
        return None
    try:
        from bhr_tpu_torch.utils.profiling import SPANS
    except ImportError:  # a program without the span table
        return None
    after = (rec.get("profile", {}).get("frames", 0)
             + len(rec.get("key_steps_ms", ())))
    kept = SPANS.samples("session.enqueue")
    window = kept[:max(len(kept) - after, 0)][-n:]
    return statistics.median(window) * 1e3 if window else None
