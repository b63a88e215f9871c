"""Build the CUDA kernels from ``csrc/*.cu`` at first use and load them.

``nvcc`` compiles the sources into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes) for
Hopper's ``sm_90a``: one ``nvcc -c`` per ``.cu`` file, all started together,
then one link. The library goes to ``<repo>/build/kernels/``, named by a
hash of the sources (headers included) and flags, and is reused while the
hash matches.
It is loaded with :mod:`ctypes`; every entry point takes device pointers
and the CUDA stream as ``c_void_p``, sizes as ``c_int`` and scalars as
``c_float`` (``c_longlong`` and ``c_double`` for the init draw's counts
and cached Gaussian), and returns the launch's ``cudaError_t``.

A missing ``nvcc`` or a failed build raises with the compiler's output; no
caller falls back to the plain PyTorch versions on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["KernelLibrary", "load_kernels", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _D = ctypes.c_longlong, ctypes.c_double
# entry point -> argtypes, as csrc/*.cu declare them
SIGNATURES = {
    "tg_rowstats": (_P,) * 4 + (_I,) * 4 + (_P,),
    "tg_rowstats_norms": (_P,) * 6 + (_I,) * 4 + (_P,),
    "tg_project": (_P,) * 8 + (_I,) * 8 + (_P,),
    "tg_rbar": (_P,) * 10 + (_I,) * 9 + (_P,),
    "tg_dm_adam": (_P,) * 17 + (_I,) * 5 + (_F,) * 5 + (_I,) * 9 + (_P,),
    "tg_gsq_tc": (_P,) * 13 + (_I,) * 4 + (_F,) * 2 + (_I,) * 5 + (_P,),
    "tg_dm_adafactor_tc": (_P,) * 17 + (_I,) * 5 + (_F,) * 3 + (_I,) * 7 + (_P,),
    "tg_dm_backward_tc": (_P,) * 13 + (_I,) * 9 + (_P,),
    "tg_dp_wgmma_operand": (_P,) * 2 + (_I,) * 6 + (_P,),
    "tg_rbar_wgmma": (_P,) * 10 + (_I,) * 9 + (_P,),
    "tg_normal_pass_a": (_P,) + (_I,) * 3 + (_L,) + (_P,) * 5,
    "tg_normal_pass_b": (_P,) + (_I,) * 3 + (_P,) * 2 + (_L,) * 2 + (_I, _D, _P, _I, _P, _L, _P),
}


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded kernels plus what the build reported."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a cached library was reused
    log: str  # nvcc's output (ptxas register and spill report)

    def call(self, name: str, *args) -> None:
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(
                f"{name}: kernel launch failed with cudaError_t {err}"
            )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (searched PATH and CUDA_HOME); the tangram_tpu_torch "
        "CUDA kernels are built from source at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest(nvcc: str, flags: tuple) -> str:
    h = hashlib.sha256()
    h.update(" ".join((nvcc,) + flags).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=2)
def load_kernels(extra_flags: tuple = ()) -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process and
    set of ``extra_flags`` (``-D...`` for nvcc; the wrappers take the
    library built with none)."""
    nvcc = _nvcc()
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = _digest(nvcc, flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"mapper_kernels-{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        t0 = time.perf_counter()
        # build under private names, then rename: concurrent builds never
        # load a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objects = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
            cmds = [[nvcc, *flags, "-c", "-o", obj, str(src)]
                    for obj, src in zip(objects, _sources())]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for cmd in cmds]
            logs = [proc.communicate()[0] for proc in procs]
            lib_tmp = os.path.join(tmp, "lib.so")
            link = [nvcc, "-shared", "-o", lib_tmp, *objects]
            failed = [i for i, proc in enumerate(procs) if proc.returncode != 0]
            if not failed:
                proc = subprocess.run(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                cmds.append(link)
                logs.append(proc.stdout)
                if proc.returncode != 0:
                    failed = [len(cmds) - 1]
            if failed:
                raise RuntimeError(
                    "nvcc failed building the tangram_tpu_torch kernels:\n"
                    + "\n".join(" ".join(cmds[i]) + "\n" + logs[i] for i in failed)
                )
            log_path.write_text("".join(logs))
            os.replace(lib_tmp, lib_path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in ("tg_dp_profile_read", "tg_pj_profile_read"):
        if hasattr(lib, name):  # built with -DTG_DP_PROFILE
            getattr(lib, name).argtypes = (_P,)
            getattr(lib, name).restype = ctypes.c_int
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(lib=lib, path=lib_path, build_seconds=seconds, log=log)
