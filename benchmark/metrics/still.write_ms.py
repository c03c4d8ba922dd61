"""Still: the median host ms of ``utils.io.save_image`` (quantise, PNG
encode and write) over the window's stills, on the driver's clock."""

import statistics


def read(rec):
    stills = rec.get("stills")
    if rec.get("driver") != "still" or not stills:
        return None
    return statistics.median(s["write_ms"] for s in stills)
