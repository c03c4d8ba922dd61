"""AA / flare: the lens flare and the uint8 quantise, ms a frame (the
video engine's CUDA-event stage mark ``stage_ms["flare"]``, a stage of a
flare scene alone), the median over the window's jobs; nothing where the
program reports no such stage."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["flare"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("flare") is not None]
    return statistics.median(vals) if vals else None
