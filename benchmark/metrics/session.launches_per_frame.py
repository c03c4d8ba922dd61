"""Session: the host's kernel-launch runtime calls per step over the
traced steps (torch.profiler)."""


def read(rec):
    prof = rec.get("profile")
    if rec.get("driver") != "session" or not prof or not prof["launches"]:
        return None
    return prof["launches"] / prof["frames"]
