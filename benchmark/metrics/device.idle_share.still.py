"""Device: share (%) of the traced stills' wall time with no kernel or
copy on the card."""

from benchmark.devtrace import idle_share


def read(rec):
    prof = rec.get("profile")
    if rec.get("driver") != "still" or not prof or not prof["busy_s"]:
        return None
    return idle_share(prof, rec["n_devices"])
