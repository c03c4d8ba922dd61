"""Video engine: a job's set-up, from its start to its first batch's
enqueue (progress, skybox, lifecycle system and packing, renderer,
writers), in ms per frame of the job (the span ``video.job_setup``,
``stage_ms["job_setup"]`` of ``modes.render_video``), the median over the
window's jobs."""

import statistics


def read(rec):
    vals = [j["stage_ms"]["job_setup"] for j in rec.get("jobs", ())
            if j["stage_ms"].get("job_setup") is not None]
    return statistics.median(vals) if vals else None
