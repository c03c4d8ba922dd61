"""Writers: ms a frame the video engine's main thread waited on the PNG
and video writers (``writer_wait_s`` of ``modes.render_video``), over
every frame of the window's jobs."""


def read(rec):
    jobs = [j for j in rec.get("jobs", ()) if j.get("writer_wait_s") is not None]
    frames = sum(j["frames"] for j in jobs)
    if not frames:
        return None
    return sum(j["writer_wait_s"] for j in jobs) / frames * 1e3
