"""Build and load the port's CUDA kernels.

Every ``hifigan_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc`` for
Hopper (``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  No PyTorch header
is included, so the build takes seconds.  ``ptxas -v`` reports each kernel's
registers, spills and static shared memory; :data:`ptxas` keeps a summary
of it when this process ran the build.

The library is built at first use into ``build/hifigan_tpu_torch/`` at the
root of the checkout and named by a hash of the sources, so an edited source
gets a new library.  The build runs in a temporary directory and the library
is renamed into place, so two processes building at once do not race.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "hifigan_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_NVCC_TIMEOUT_S = 600

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran, if any
ptxas: str | None = None  # per-kernel summary of ``ptxas -v`` from the build this process ran


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").is_file():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhifigan_kernels_{digest.hexdigest()[:16]}.so"


def _kernel_name(mangled: str) -> str:
    """The innermost name of an Itanium-mangled name such as
    ``_ZN12_GLOBAL__N_115grc_step_kernelIfEEv...`` (→ ``grc_step_kernel``)."""
    pos = re.match(r"_ZN?", mangled).end() if mangled.startswith("_Z") else 0
    name = mangled
    while d := re.match(r"\d+", mangled[pos:]):
        pos += d.end()
        name = mangled[pos:pos + int(d.group())]
        pos += int(d.group())
    return name


def summarise_ptxas(text: str) -> str:
    """One line per kernel from ``ptxas -v`` output: registers a thread,
    spill stores and loads, static shared memory."""
    lines, name, spills = [], None, ""
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = _kernel_name(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(f"{name}: {m.group(1)} registers, {spills}, "
                         f"{smem.group(1) if smem else 0} B static smem")
            name, spills = None, ""
    return "\n".join(lines)


def _build(path: Path) -> str:
    """Compile each source with its own nvcc, all started together, link
    them into ``path`` and return the ``ptxas -v`` summary."""
    nvcc = _nvcc()
    sources = sorted(_CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        reports = []
        try:
            for src, proc in zip(sources, procs):
                out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{out}")
                reports.append(out)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = Path(tmp) / path.name
        link = [nvcc, "-shared", "-o", str(lib), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True, timeout=_NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, path)
    return summarise_ptxas("\n".join(reports))


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds, ptxas
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        ptxas = _build(path)
        build_seconds = time.perf_counter() - start
    _lib = ctypes.CDLL(str(path))
    return _lib
