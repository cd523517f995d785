"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch_kernels/<hash>/`` at the repository root (git-ignored).
The hash covers the sources, their shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds.
All sources compile at once, one ``nvcc`` process each.  A missing
``nvcc`` or a failed build raises: nothing falls back to the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# -I csrc: copies of a source built elsewhere (the ablation scripts) still
# find the shared headers (csrc/*.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC))

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then from ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> float:
    """Compile every source not built yet; returns the seconds spent.

    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside each library as ``<name>.log``."""
    out_dir = _build_dir()
    todo = [s for s in _sources()
            if not (out_dir / f"lib{s.stem}.so").is_file()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        log = open(out_dir / f"{src.stem}.log", "w")  # noqa: SIM115
        procs.append((src, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
        else:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out_dir / f"{src.stem}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building first if
    needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        path = _build_dir() / f"lib{name}.so"
        if not path.is_file():
            raise RuntimeError(f"no kernel source csrc/{name}.cu")
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
