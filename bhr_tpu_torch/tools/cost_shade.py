"""What bounds the FHD deferred shade: launches, bytes or operations.

The port of ``tools/cost_shade.py``, which read XLA's cost analysis of
the compiled shade and set its FLOPs and bytes against the TPU's peaks.
Eager torch has no compiled module to ask, so the same answer is reached
from the shade itself, on the diagnostic scene (``_diag_scene``):

- its FP32 operations, counted per ATen operator while one shade runs
  (``fp32_operations``: one per output element of an arithmetic op, one
  per input element of a sum; compares, selects, clamps, casts, indexing
  and copies are not counted, as the trace's op model counts no
  fmin/fmax or compare);
- the bytes it must move (``shade_bytes``: each input byte read once and
  each output byte written once, the texture and sky gathers capped at
  the texels the hits can reach);
- its launches and device time from ``torch.profiler`` and its wall
  time on the host clock.

It prints the bytes' bound and the operations' bound at the H100's
published peaks (``bench.PEAK_BYTES``, ``bench.PEAK_FP32``) with the
card's power limit beside them, and says whether the shade is launch-,
bandwidth- or compute-bound: launch-bound where the card is busy less
than half of the wall time, else bound by the larger of the two bounds,
with that bound's share of the device time (the eager shade's separate
kernels write and read back intermediates that the bound, each input
and output once, does not count).
On the CPU only the counts are printed.

Usage:
    python -m bhr_tpu_torch.tools.cost_shade [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

import torch

from ..config import DEVICES

# Arithmetic operators counted one FP32 operation per output element,
# and reductions counted one per input element.
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "reciprocal", "sqrt", "rsqrt", "exp",
    "exp2", "log", "log2", "pow", "sin", "cos", "tan", "asin", "acos", "atan",
    "atan2", "tanh", "sigmoid", "floor", "ceil", "remainder", "fmod"))
_REDUCTIONS = frozenset(("sum", "mean", "prod", "cumsum"))


def fp32_operations(fn) -> tuple:
    """(FP32 operations of one call of ``fn``, Counter of them by ATen
    operator), counted as the module docstring says."""
    from torch.utils._python_dispatch import TorchDispatchMode

    by_op = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _ELEMENTWISE and isinstance(out, torch.Tensor) \
                    and out.dtype.is_floating_point:
                by_op[name] += out.numel()
            elif name in _REDUCTIONS and isinstance(args[0], torch.Tensor) \
                    and args[0].dtype.is_floating_point:
                by_op[name] += args[0].numel()
            return out

    with Count():
        fn()
    return sum(by_op.values()), by_op


def shade_bytes(trace, skybox, mips) -> int:
    """Bytes the non-AA shade of ``trace`` must move: the hit features it
    reads (x, y and direction of each populated slot), hit_count,
    escaped, escape_dir; the level-0 texture, at most 4 texels of 16
    bytes for each valid hit; the sky, at most 4 texels of 12 bytes for
    each escaped ray; and the bg, disk (N x 3) and alpha (N) written."""
    n = trace.hit_count.numel()
    slots = max(1, min(trace.hits.shape[0], int(trace.hit_count.max())))
    hits = int(trace.hit_count.clamp(max=trace.hits.shape[0]).sum())
    reads = (slots * 5 * n * 4 + n * 4 + n * 1 + n * 12
             + min(mips[0].numel() * 4, hits * 4 * 16)
             + min(skybox.numel() * 4, int(trace.escaped.sum()) * 4 * 12))
    return reads + n * (3 + 3 + 1) * 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--size", default="1920x1080", help="WxH of the scene")
    ap.add_argument("--tex", default="416x2912", help="n_r x n_phi of the disk")
    args = ap.parse_args(argv)

    from .. import bench
    from ..pipeline import shade_frame
    from ..utils.profiling import device_time
    from ._diag_scene import build_fhd_shade_inputs, shade_kwargs

    w, h, cam, skybox, mips, trace = build_fhd_shade_inputs(
        args.device, tuple(int(v) for v in args.size.split("x")),
        tuple(int(v) for v in args.tex.split("x")))

    def shade():
        return shade_frame(trace, skybox, mips, cam[0:3], **shade_kwargs())

    shade()  # warm
    ops, by_op = fp32_operations(shade)
    nbytes = shade_bytes(trace, skybox, mips)
    t_ops, t_bytes = ops / bench.PEAK_FP32 * 1e3, nbytes / bench.PEAK_BYTES * 1e3
    print(f"shade of the {w}x{h} scene on {args.device}: FP32 operations "
          f"{ops / 1e9:.4f} G ({', '.join(f'{k} {v / 1e6:.1f} M' for k, v in by_op.most_common(6))}); "
          f"bytes {nbytes / 1e9:.4f} GB")
    if mips.device.type != "cuda":
        print("bounds, launches and device time: not measured (no GPU)")
        return 0
    power = bench.gpu_query("power.limit")
    busy_us, kernels, wall_us = bench.profile_device(shade)
    dev_ms = device_time(shade, iters=10) * 1e3
    print(f"roofline at the H100's published peaks ({torch.cuda.get_device_name(mips.device)}, "
          f"power limit {power} W): operations {t_ops:.4f} ms "
          f"({bench.PEAK_FP32 / 1e12:.0f} TFLOP/s) | bytes {t_bytes:.4f} ms "
          f"({bench.PEAK_BYTES / 1e12:.2f} TB/s)")
    print(f"torch.profiler: {kernels} kernels and copies, device busy "
          f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"({busy_us / wall_us:.1%}); 10 enqueued shades: {dev_ms:.3f} ms each")
    if busy_us < 0.5 * wall_us:
        verdict = (f"launch-bound: the card idles {1 - busy_us / wall_us:.0%} of "
                   f"the wall time while the host enqueues {kernels} launches")
    else:
        roof, kind = max((t_bytes, "bandwidth"), (t_ops, "compute"))
        verdict = (f"{kind}-bound: the higher roof, {roof:.4f} ms, is {roof / dev_ms:.1%} "
                   f"of the device time; its {kernels} unfused kernels "
                   f"({busy_us / kernels:.1f} µs each) move intermediates that the "
                   f"one-pass bound does not count")
    print(f"verdict: {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
