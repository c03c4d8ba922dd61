"""Device: share (%) of the traced video job's wall time with no kernel
or copy on a card, the mean over the cell's cards."""

from benchmark.devtrace import idle_share


def read(rec):
    prof = rec.get("profile")
    if rec.get("driver") != "video" or not prof or not prof["busy_s"]:
        return None
    return idle_share(prof, rec["n_devices"])
