"""Still: the host's kernel-launch runtime calls per still in the traced
stills (torch.profiler), everything ``render_image`` and the PNG write
launch: the lifecycle or the static generator, trace, shade, post."""


def read(rec):
    prof = rec.get("profile")
    if rec.get("driver") != "still" or not prof or not prof["launches"]:
        return None
    return prof["launches"] / prof["frames"]
