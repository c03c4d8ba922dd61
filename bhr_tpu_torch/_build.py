"""Build the sources of ``csrc/`` into shared libraries, at first use.

Each ``csrc/*.cu`` file is one library with a plain C interface, built
by ``nvcc`` for Hopper (``sm_90a``) and loaded with ``ctypes`` — seconds
per build, where a source that includes PyTorch's headers takes minutes.
Each ``csrc/*.cpp`` file is a host library built the same way by ``g++``
(``build_host``), with a list of link attempts tried in order (the PNG
encoder links libdeflate where the host has it, else zlib). A library
lands in ``bhr_tpu_torch/_build/`` under a name keyed by a hash of the
source, the flags and the attempts, so a changed source or flag rebuilds
and an unchanged one loads the existing file, whichever attempt built it;
an existing file that does not load (built on a host with other
libraries) is built again. The directory is read through
``utils.cache.compile_cache_dir()`` at each build: ``BUILD_DIR`` unless
``utils.cache.disable_compile_cache()`` (``--no_compile_cache``) has
given the process a private one.

The build runs only from the sources in this package. A missing
compiler, or a compile error in every attempt, raises with the
compiler's output of each attempt; nothing here degrades to another
implementation.
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
    return _build(os.path.join(CSRC_DIR, f"{name}.cu"), find_nvcc, NVCC_FLAGS, ((),))


def build_host(name: str, *link_attempts) -> Built:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` unless its
    keyed build exists, and load it. Each of ``link_attempts`` is a tuple
    of flags put after the source; they are tried in order and the first
    that builds wins (none given: one attempt without flags). Raises
    RuntimeError when there is no ``g++`` or every attempt fails, e.g. for
    a missing library or header, with each attempt's compiler output."""
    def find_gxx() -> str:
        found = shutil.which("g++")
        if not found:
            raise RuntimeError("g++ not found on PATH")
        return found

    return _build(os.path.join(CSRC_DIR, f"{name}.cpp"), find_gxx, HOST_FLAGS,
                  tuple(tuple(a) for a in link_attempts) or ((),))


def _build(src: str, find_compiler, flags, link_attempts) -> Built:
    from .utils.cache import compile_cache_dir

    build_dir = compile_cache_dir()
    name = os.path.splitext(os.path.basename(src))[0]
    with open(src, "rb") as f:
        source = f.read()
    digest = hashlib.sha256(source + " | ".join(
        " ".join((*flags, *attempt)) for attempt in link_attempts).encode()
                            ).hexdigest()
    out = os.path.join(build_dir, f"lib{name}_{digest[:16]}.so")
    log_path = out + ".log"
    seconds = 0.0
    if not os.path.isfile(out):
        compiler = find_compiler()
        os.makedirs(build_dir, exist_ok=True)
        # Build to a temporary name and rename, so a concurrent or
        # interrupted build never leaves a half-written library behind.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            logs = []  # the compiler's output of each attempt, failed ones too
            for attempt in link_attempts:
                proc = subprocess.run(
                    [compiler, *flags, "-o", tmp, src, *attempt],
                    capture_output=True, text=True,
                )
                logs.append(f"[{' '.join(attempt) or 'no link flags'}: exit "
                            f"{proc.returncode}]\n{proc.stdout}{proc.stderr}")
                if proc.returncode == 0:
                    break
            else:
                raise RuntimeError(
                    f"{os.path.basename(compiler)} failed to build {src} "
                    f"({len(logs)} attempt(s)):\n" + "".join(logs))
            with open(log_path, "w") as f:
                f.write("".join(logs))
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
        shown = (os.path.relpath(out, _PKG_DIR) if build_dir == BUILD_DIR
                 else out)
        print(f"built {shown} in {seconds:.2f} s (set-up)")
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        if seconds:  # built just now: a real failure
            raise
        # A library built on another host (a copied or shared checkout) can
        # link a library this host lacks: build it again here.
        os.unlink(out)
        return _build(src, find_compiler, flags, link_attempts)
    log = ""
    if os.path.isfile(log_path):
        with open(log_path) as f:
            log = f.read()
    return Built(lib, out, seconds, log)
