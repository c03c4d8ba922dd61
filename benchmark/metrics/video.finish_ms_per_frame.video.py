"""Writers: a job's finish, from the writers' drain to the video file on
disk (the MJPEG post-pass where the host has no H.264 codec), in ms per
frame of the job (the span ``video.finish``, ``stage_ms["finish"]`` of
``modes.render_video``), the median over the window's jobs."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["finish"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("finish") is not None]
    return statistics.median(vals) if vals else None
