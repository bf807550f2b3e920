"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, ``build/torch_kernels/
libm2mixer_torch_kernels.so`` at the repository root, and loaded with
``ctypes``. The build runs at first use, never at import: modules that hold
kernel wrappers import cleanly on machines without a GPU toolchain, where
their wrappers only ever see CPU tensors. The library is rebuilt when the
sources' hash changes. Each source compiles in its own ``nvcc`` process, all
started together, and the objects are linked once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library", "build_library", "launch_tally", "CSRC_DIR", "BUILD_DIR",
           "TALLIED_KERNELS"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libm2mixer_torch_kernels.so"
# the kernels the library tallies where it enqueues them (mixer_common.cuh's
# M2mTally order)
TALLIED_KERNELS = ("wg_gemm_kernel", "tc_gemm_kernel", "tok_in_kernel", "gmlp_vt_kernel")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

_LIB = None
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
                       "are built from source at first use")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(COMMON_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.hexdigest()


def _run_all(cmds) -> str:
    """Run the commands side by side; return their joined output, or raise
    with the output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs, failures = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0:
            failures.append(logs[-1])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return "\n".join(logs)


def build_library(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the shared library
    unless an up-to-date build exists. Returns its path; raises with nvcc's
    output on failure. ``verbose`` prints ptxas's register and shared-memory
    report of a fresh build."""
    sources = _sources()
    digest = _digest(sources)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib_path.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        log = _run_all([[nvcc, *COMMON_FLAGS, *extra, "-c", str(s), "-o", str(o)]
                        for s, o in zip(sources, objs)])
        if verbose:
            print(log)
        staged = Path(tmp) / LIB_NAME
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(staged)]])
        os.replace(staged, lib_path)
    stamp.write_text(digest)
    return lib_path


def _declare(lib):
    c_int, c_void_p, c_size_t = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
    # dropout: 4 stream keys per block (or None), keep threshold, keep scale
    dropout = [ctypes.POINTER(ctypes.c_uint), ctypes.c_uint, ctypes.c_float]
    lib.m2m_error_string.argtypes = [c_int]
    lib.m2m_error_string.restype = ctypes.c_char_p
    lib.m2m_launch_tally.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.m2m_launch_tally.restype = None
    lib.m2m_mixer_fwd_workspace_bytes.argtypes = [c_int] * 8
    lib.m2m_mixer_fwd_workspace_bytes.restype = c_size_t
    lib.m2m_mixer_fwd.argtypes = ([c_void_p] * 3 + [c_int] * 9 + dropout
                                  + [c_int, c_int] + [c_void_p] * 3)
    lib.m2m_mixer_fwd.restype = c_int
    lib.m2m_mixer_bwd_workspace_bytes.argtypes = [c_int] * 9
    lib.m2m_mixer_bwd_workspace_bytes.restype = c_size_t
    lib.m2m_mixer_bwd.argtypes = ([c_void_p] * 3 + [c_int] * 9 + dropout
                                  + [c_int, c_int] + [c_void_p] * 4)
    lib.m2m_mixer_bwd.restype = c_int
    lib.m2m_mixer_fwd_token_ff.argtypes = [c_int] * 6
    lib.m2m_mixer_fwd_token_ff.restype = c_int
    lib.m2m_mixer_bwd_token_ff.argtypes = [c_int] * 6
    lib.m2m_mixer_bwd_token_ff.restype = c_int
    lib.m2m_mixer_token_row_slice.argtypes = [c_int] * 6
    lib.m2m_mixer_token_row_slice.restype = c_int
    lib.m2m_mixer_row_slice.argtypes = [c_int] * 6
    lib.m2m_mixer_row_slice.restype = c_int
    lib.m2m_wg_product.argtypes = ([c_int] * 8 + [c_void_p, ctypes.c_longlong] * 2
                                   + [c_void_p, c_int, c_void_p])
    lib.m2m_wg_product.restype = c_int
    lib.m2m_gmlp_workspace_bytes.argtypes = [c_int] * 7
    lib.m2m_gmlp_workspace_bytes.restype = c_size_t
    lib.m2m_gmlp_row_slice.argtypes = [c_int] * 5
    lib.m2m_gmlp_row_slice.restype = c_int
    lib.m2m_tc_tile_rows.argtypes = [c_int] * 4
    lib.m2m_tc_tile_rows.restype = c_int
    lib.m2m_gmlp_fwd.argtypes = ([c_void_p] * 2 + [c_int] * 5 + dropout + [c_int] * 2
                                 + [c_void_p] * 3)
    lib.m2m_gmlp_fwd.restype = c_int
    lib.m2m_gmlp_bwd.argtypes = ([c_void_p] * 3 + [c_int] * 5 + dropout + [c_int] * 2
                                 + [c_void_p] * 4)
    lib.m2m_gmlp_bwd.restype = c_int
    lib.m2m_dyna_workspace_bytes.argtypes = [c_int] * 8
    lib.m2m_dyna_workspace_bytes.restype = c_size_t
    lib.m2m_dyna_row_slice.argtypes = [c_int] * 6
    lib.m2m_dyna_row_slice.restype = c_int
    lib.m2m_dyna_fwd.argtypes = [c_void_p] * 2 + [c_int] * 7 + [c_void_p] * 3
    lib.m2m_dyna_fwd.restype = c_int
    lib.m2m_dyna_bwd.argtypes = [c_void_p] * 3 + [c_int] * 7 + [c_void_p] * 4
    lib.m2m_dyna_bwd.restype = c_int
    return lib


def load_library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _declare(ctypes.CDLL(str(build_library())))
        return _LIB


def launch_tally() -> dict:
    """{kernel: launches since the library was loaded} of TALLIED_KERNELS,
    counted on the host where the library enqueues them: exact, where a
    profiler trace may drop events."""
    out = (ctypes.c_ulonglong * len(TALLIED_KERNELS))()
    load_library().m2m_launch_tally(out)
    return dict(zip(TALLIED_KERNELS, out))


def check(lib, code: int, what: str) -> None:
    """Raise with the CUDA error string when a C entry point returned != 0."""
    if code != 0:
        msg = lib.m2m_error_string(int(code)).decode()
        raise RuntimeError(f"{what} failed: {msg} (code {code})")
