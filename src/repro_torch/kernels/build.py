"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each ``csrc/<stem>.cu`` is compiled by its own ``nvcc`` process (all of
them started together) into ``lib<stem>-<hash>.so`` with a plain C
interface, then loaded with ``ctypes``.  The hash covers the sources and
the flags, so an edited source rebuilds and an unchanged one is reused.

The build directory is ``REPRO_TORCH_BUILD_DIR`` when set, else
``_build/`` beside this file (listed in ``.gitignore``).  ``nvcc`` is
found through ``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then
``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.read_bytes())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no current library, one
    ``nvcc`` per source, all in parallel.  Returns ``{stem: compiler
    output}`` (``-Xptxas -v`` register/spill report when ``verbose``)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path() if any(not _lib_path(s).exists()
                              for s in CSRC.glob("*.cu")) else None
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        dst = _lib_path(src)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, dst)
    logs, failed = {}, []
    for stem, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            path = _lib_path(CSRC / f"{stem}.cu")
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _LIBS[stem] = lib
        return lib
