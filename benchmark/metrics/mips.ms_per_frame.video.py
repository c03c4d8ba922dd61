"""AA / flare: the disk texture's mip pyramid, ms a frame (the video
engine's CUDA-event stage mark ``stage_ms["mips"]``, a stage of an AA
scene alone), the median over the window's jobs; nothing where the
program reports no such stage."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["mips"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("mips") is not None]
    return statistics.median(vals) if vals else None
