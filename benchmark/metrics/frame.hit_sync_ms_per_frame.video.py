"""Device: the host's one wait inside a frame, when the shade reads the
most hits of any ray (the span ``frame.hit_sync``, the median of a job's
frames, ``stage_ms["hit_sync"]`` of ``modes.render_video``), ms, the
median over the window's jobs. It reads what the device's queue still
held at that read: the frame's trailing texture kernels and its trace,
less what other cards' work overlaps."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["hit_sync"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("hit_sync") is not None]
    return statistics.median(vals) if vals else None
