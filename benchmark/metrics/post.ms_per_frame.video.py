"""Post: bloom, clamp and the uint8 quantise, ms a frame (the video
engine's ``stage_ms["post"]``), the median over the window's jobs."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["post"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("post") is not None]
    return statistics.median(vals) if vals else None
