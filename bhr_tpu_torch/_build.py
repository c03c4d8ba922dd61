"""Build the sources of ``csrc/`` into shared libraries, at first use.

Each ``csrc/*.cu`` file is one library with a plain C interface, built
by ``nvcc`` for Hopper (``sm_90a``) and loaded with ``ctypes`` — seconds
per build, where a source that includes PyTorch's headers takes minutes.
Each ``csrc/*.cpp`` file is a host library built the same way by ``g++``
(``build_host``). A library lands in ``bhr_tpu_torch/_build/`` under a
name keyed by a hash of the source and the flags, so a changed source or
flag rebuilds and an unchanged one loads the existing file.

The build runs only from the sources in this package. A missing
compiler or a compile error raises with the compiler's output; nothing
here degrades to another implementation.
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
    log: str  # the compiler's output (nvcc: ptxas registers and spills)


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


HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless its keyed build exists, and load it."""
    return _build(os.path.join(CSRC_DIR, f"{name}.cu"), find_nvcc, NVCC_FLAGS, ())


def build_host(name: str, link_flags=()) -> Built:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` (and
    ``link_flags`` after the source) unless its keyed build exists, and
    load it. Raises RuntimeError when there is no ``g++`` or the build
    fails, e.g. for a missing library or header."""
    def find_gxx() -> str:
        found = shutil.which("g++")
        if not found:
            raise RuntimeError("g++ not found on PATH")
        return found

    return _build(os.path.join(CSRC_DIR, f"{name}.cpp"), find_gxx, HOST_FLAGS,
                  tuple(link_flags))


def _build(src: str, find_compiler, flags, link_flags) -> Built:
    name = os.path.splitext(os.path.basename(src))[0]
    with open(src, "rb") as f:
        source = f.read()
    digest = hashlib.sha256(
        source + " ".join((*flags, *link_flags)).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")
    log_path = out + ".log"
    seconds = 0.0
    if not os.path.isfile(out):
        compiler = find_compiler()
        os.makedirs(BUILD_DIR, exist_ok=True)
        # Build to a temporary name and rename, so a concurrent or
        # interrupted build never leaves a half-written library behind.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [compiler, *flags, "-o", tmp, src, *link_flags],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{os.path.basename(compiler)} failed to build {src} "
                    f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
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
