"""Shade: the lifecycle disk's deferred shade, ms a frame (the video
engine's ``stage_ms["shade"]``), the median over the window's jobs."""

import statistics


def read(rec):
    if rec.get("disk_model") != "texture":
        return None
    vals = [j["stage_ms"]["shade"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("shade") is not None]
    return statistics.median(vals) if vals else None
