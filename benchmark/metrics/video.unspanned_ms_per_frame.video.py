"""Video engine: the main thread's time that no top-level span covers,
in ms per frame: a job's host-clock time (``drivers/video.py``'s, around
``modes.render_video``) over its frames, less its ``job_setup``,
``enqueue``, ``record`` and ``finish`` spans (``stage_ms``), the median
over the window's jobs."""

import statistics

SPANS = ("job_setup", "enqueue", "record", "finish")


def read(rec):
    vals = [(j["t1"] - j["t0"]) * 1e3 / j["frames"]
            - sum(j["stage_ms"][k] for k in SPANS)
            for j in rec.get("jobs", ())
            if j.get("frames") and all(j["stage_ms"].get(k) is not None
                                       for k in SPANS)]
    return statistics.median(vals) if vals else None
