"""Build the CUDA sources of ``csrc/`` into a shared library, at first use.

Each ``csrc/*.cu`` file is one library with a plain C interface, built
by ``nvcc`` for Hopper (``sm_90a``) and loaded with ``ctypes`` — seconds
per build, where a source that includes PyTorch's headers takes minutes.
The library lands in ``bhr_tpu_torch/_build/`` under a name keyed by a
hash of the source and the flags, so a changed source or flag rebuilds
and an unchanged one loads the existing file.

The build runs only from the sources in this package. A missing ``nvcc``
or a compile error raises with the compiler's output; nothing degrades
to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# The ray-march kernel is bound by instruction issue (see
# csrc/ray_march.cu), so nvcc's default -fmad=true stays: a multiply and
# the add that follows it issue as one FFMA. --use_fast_math stays off:
# the kernels name the approximation they mean (PTX rsqrt.approx.ftz) and
# the correctly rounded intrinsics (__fsqrt_rn, __frcp_rn) in the source,
# so no global flag changes what a sqrt, rsqrt or reciprocal computes.
# -Xptxas -v reports registers, shared memory and spills into the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    """A loaded kernel library and how it came to be."""

    lib: ctypes.CDLL
    path: str
    seconds: float  # compile time; 0.0 when an existing build was loaded
    log: str  # nvcc's output (ptxas register and spill report)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of bhr_tpu_torch are built from source at first use"
    )


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless its keyed build exists, and load it."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        source = f.read()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")
    log_path = out + ".log"
    seconds = 0.0
    if not os.path.isfile(out):
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # Build to a temporary name and rename, so a concurrent or
        # interrupted build never leaves a half-written library behind.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            with open(log_path, "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
        print(f"built {os.path.relpath(out, _PKG_DIR)} in {seconds:.2f} s "
              "(set-up)")
    log = ""
    if os.path.isfile(log_path):
        with open(log_path) as f:
            log = f.read()
    return Built(ctypes.CDLL(out), out, seconds, log)
