"""Video engine: the host's time enqueueing the job's batches (the span
``video.enqueue``, ``stage_ms["enqueue"]`` of ``modes.render_video``), in
ms per frame of the job, the median over the window's jobs."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["enqueue"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("enqueue") is not None]
    return statistics.median(vals) if vals else None
