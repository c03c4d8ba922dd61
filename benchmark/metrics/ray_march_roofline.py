"""Trace kernel: the ray-march kernel's share (%) of its roofline in the
traced job: the least time the card could take for the work these
frames need (``benchmark/opmodel.py``, steps counted by the reference's
plain tracer), over the mean device time of a ``ray_march`` launch
(torch.profiler)."""

from benchmark.opmodel import bound_ms


def read(rec):
    prof, work = rec.get("profile"), rec.get("trace_work")
    if not prof or not work:
        return None
    runs = [v for name, v in prof["kernels"].items() if "ray_march" in name]
    count = sum(v[0] for v in runs)
    seconds = sum(v[1] for v in runs)
    if not count or seconds <= 0:
        return None
    least_ms, _ = bound_ms(work["variant"], work["per_frame"])
    return 100.0 * least_ms / (seconds / count * 1e3)
