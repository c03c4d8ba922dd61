"""The NaN trap of ``--debug_nans``: the port's ``jax_debug_nans``.

``bhr_tpu`` sets ``jax_debug_nans``, under which JAX checks the outputs
of every compiled computation for NaN and raises ``FloatingPointError``.
PyTorch runs eagerly and compiles nothing, so the port checks where
``bhr_tpu``'s ``jax.jit`` boundaries are: every stage of a frame calls
:func:`check_nans` on its outputs (the stages and their names are listed
at each call). What is checked is what JAX checks:

* NaN only. Inf is ``jax_debug_infs``, which ``bhr_tpu`` never sets, so
  an Inf passes here too.
* A stage's outputs, never a value inside it: a ``torch.where`` that
  masks a NaN within a stage does not fire.

Where JAX names the primitive that made the NaN, the message here names
the stage. The error is raised and never caught by the port.

Off (the default), :func:`check_nans` returns before it touches a
tensor: no reduction, no copy, no synchronise. On, a stage costs one
NaN count per floating-point output and one synchronise to read them.
The switch is process-wide, as JAX's configuration is.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List

import torch

_enabled = False


def set_debug_nans(on: bool) -> None:
    """Turn the trap on or off for the whole process."""
    global _enabled
    _enabled = bool(on)


def debug_nans_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def debug_nans(on: bool = True):
    """The trap set to ``on`` inside the block and restored after it, as
    ``jax.debug_nans``."""
    prev = _enabled
    set_debug_nans(on)
    try:
        yield
    finally:
        set_debug_nans(prev)


def _float_tensors(values) -> Iterable[torch.Tensor]:
    """The floating-point tensors among ``values``, looking into tuples
    (a ``TraceResult``, a stage's several outputs); None is skipped."""
    for v in values:
        if isinstance(v, torch.Tensor):
            if v.is_floating_point():
                yield v
        elif isinstance(v, (tuple, list)):
            yield from _float_tensors(v)


def _count_nans(tensors: List[torch.Tensor]) -> int:
    """The NaNs in ``tensors``: one count per tensor, summed on the first
    one's device, and one synchronise to read the sum."""
    dev = tensors[0].device
    return int(sum(torch.isnan(t).sum().to(dev) for t in tensors))


def check_nans(stage: str, *outputs) -> None:
    """Raise ``FloatingPointError`` naming ``stage`` if the trap is on
    and any floating-point tensor of ``outputs`` holds a NaN."""
    if not _enabled:
        return
    tensors = list(_float_tensors(outputs))
    if not tensors:
        return
    n = _count_nans(tensors)
    if n:
        numel = sum(t.numel() for t in tensors)
        raise FloatingPointError(
            f"invalid value (nan) encountered in {stage}: {n} of {numel} "
            "values")
