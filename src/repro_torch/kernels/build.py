"""Build the CUDA kernels under `csrc/` at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so one
`nvcc` call per source takes seconds. All sources are compiled in parallel,
one `nvcc` process each, into ``build/kernels/`` at the repository root
(listed in `.gitignore`). A library's file name carries a hash of its source,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source is
rebuilt and an unchanged one is reused.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

Nothing here runs at import: the CPU tests import every module of the
package on a host with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_prefill", "decode_attn", "moe_grouped")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}      # compiler output of the last build of each source


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on a host with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared by every source
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library, all
    `nvcc` processes started together; raise with the compiler's output on
    the first failure. Returns {name: library path}. ``verbose`` adds
    ``-Xptxas -v``: the resource report is printed and kept in `LOGS`."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        LOGS[name] = log
        if verbose and log:
            print(log, end="")
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)           # atomic: a reader never sees half
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: str(_target(name)) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`. Its first use builds every
    source that has no up-to-date library, in parallel, so a process pays
    for one compile at most once and for the slowest source alone."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build(SOURCES)[name]
            lib = ctypes.CDLL(path)
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero `cudaGetLastError()` returned by a launch."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
