"""Set-up: seconds the process spent generating skyboxes where the cache
had none (the span ``skybox.generate`` of the program's span table);
every run makes its skybox afresh, once."""


def read(rec):
    if not rec.get("driver"):  # not a run's record
        return None
    try:
        from bhr_tpu_torch.utils.profiling import SPANS
    except ImportError:  # a program without the span table
        return None
    if not SPANS.count("skybox.generate"):
        return None
    return SPANS.total_s("skybox.generate")
