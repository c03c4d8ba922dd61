"""Disk texture: background + texture ms a frame, the video engine's
CUDA-event stage marks (``stage_ms`` of ``modes.render_video``), the
median over the window's jobs."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["background"] + j["stage_ms"]["texture"]
            for j in rec.get("jobs", ())
            if j["stage_ms"].get("background") is not None
            and j["stage_ms"].get("texture") is not None]
    return statistics.median(vals) if vals else None
