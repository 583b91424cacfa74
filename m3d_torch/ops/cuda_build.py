"""Build and load the port's C-ABI libraries: the CUDA kernels and the
native host library.

Each ``m3d_torch/csrc/<name>.cu`` builds with one plain ``nvcc -shared``
call (C ABI, no PyTorch headers: seconds, not minutes) into its own
library ``m3d_torch/_build/<name>_<tag>.so``, where ``tag`` hashes that
source and the flags (a library that calls into libcuda, as the fused
kernel does for its TMA tensor map, adds ``-lcuda``). The library is built
at first use and rebuilt when either changes; it is loaded with ctypes.
``build_all`` starts one nvcc per source at once. The host library
``csrc/m3d_native.cpp`` builds the same way with g++ (``m3d_torch/
native.py``). A build goes to a per-process temporary file that is renamed
into place, so processes that build at once do not collide; a failed
build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int


def gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native host library "
                           "(csrc/m3d_native.cpp) needs it")
    return found


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


class CudaLibrary:
    """One csrc/<name>.cu: its build, its loaded library, and the C
    functions it exports, each with its ctypes argument types. Every entry
    returns the launch's cudaError_t (0 = ok) unless ``restypes`` names
    another return type. ``compiler``, ``flags`` and ``ext`` build another
    source the same way (the host library: g++ on a .cpp)."""

    def __init__(self, name: str, functions: dict, link=(), restypes=None,
                 compiler=nvcc, flags=NVCC_FLAGS, ext=".cu"):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}{ext}")
        self.functions = functions
        self.restypes = dict(restypes or {})
        self.link = tuple(link)  # libraries, placed after the source
        self.compiler, self.flags = compiler, tuple(flags)
        self.lib = None
        self.build_seconds = None  # None: the cached library was used
        self.build_log = ""

    def path(self) -> str:
        with open(self.source, "rb") as fh:
            h = hashlib.sha256(fh.read() + " ".join(
                (*self.flags, *self.link)).encode())
        return os.path.join(BUILD_DIR, f"{self.name}_{h.hexdigest()[:16]}.so")

    def start_build(self):
        """Start nvcc unless the library exists; returns the process (or
        None) for ``finish_build``."""
        path = self.path()
        if os.path.exists(path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([self.compiler(), *self.flags, "-o", tmp,
                                 self.source, *self.link],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, path, time.perf_counter()

    def finish_build(self, started) -> str:
        if started is None:
            return self.path()
        proc, tmp, path, t0 = started
        self.build_log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(proc.args[0])} "
                               f"{self.source} failed ({proc.returncode}):"
                               f"\n{self.build_log}")
        os.replace(tmp, path)
        self.build_seconds = time.perf_counter() - t0
        return path

    def load(self):
        """Build (if needed) and load the library; idempotent."""
        if self.lib is None:
            lib = ctypes.CDLL(self.finish_build(self.start_build()))
            for fn_name, argtypes in self.functions.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = self.restypes.get(fn_name, ctypes.c_int)
            self.lib = lib
        return self.lib

    def call(self, fn_name: str, *args) -> None:
        """Call an entry of the library; raise if the launch failed."""
        err = getattr(self.load(), fn_name)(*args)
        if err != 0:
            raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def build_all(libraries) -> None:
    """Build every library not built yet, one nvcc each, all at once."""
    started = [(lib, lib.start_build()) for lib in libraries
               if lib.lib is None]
    errors = []
    for lib, st in started:  # wait for every nvcc before raising
        try:
            lib.finish_build(st)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for lib, _ in started:
        lib.load()


class LaunchCount:
    """A wrapper's count of kernel launches (added to only where the
    wrapper launches its kernel)."""

    def __init__(self):
        self.launches = 0


def on_card(dev, what: str) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (run
    the plain version); raises for any other device."""
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no {what} kernel for {dev}")
    return dev.type == "cuda"


def stream_of(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
