"""Video engine: the host's kernel-launch runtime calls per rendered frame
in the traced job (torch.profiler)."""


def read(rec):
    prof = rec.get("profile")
    if rec.get("driver") != "video" or not prof or not prof["launches"]:
        return None
    return prof["launches"] / prof["frames"]
