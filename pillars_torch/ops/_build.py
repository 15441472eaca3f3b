"""Build the port's CUDA sources at first use and load them with ctypes.

Every ``pillars_torch/csrc/*.cu`` compiles on its own with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). Libraries land in ``pillars_torch/_build/``, named by a hash
of the source and the flags, so an edited source rebuilds and an unchanged
one loads from disk. :func:`build_all` starts one ``nvcc`` per source at
once. :func:`load` also builds a variant of one source with extra ``-D``
defines (instrumentation). A missing ``nvcc`` or a failed build raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

from pillars_torch.utils import tracing

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


def _lib_path(name: str, defines: Sequence[str] = ()) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join([*NVCC_FLAGS, *(f"-D{d}" for d in defines)])
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def sources() -> List[str]:
    """Names (stems) of every CUDA source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Sequence[str] = (),
              defines: Sequence[str] = ()) -> Dict[str, str]:
    """Compile every source (or ``names``) that has no up-to-date library,
    all ``nvcc`` processes at once; returns {name: compiler output}. Raises
    on the first failed build after every process has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, _lib_path(n, defines)) for n in names or sources()
            if not _lib_path(n, defines).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use; with
    ``defines`` a variant of that one source compiled with ``-D`` each.
    The first load of each library (its build, where there is none yet) is
    the span ``build.extensions``."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            with tracing.span("build.extensions", args={"source": name}):
                path = _lib_path(name, defines)
                if not path.exists():
                    build_all((name,) if defines else (), defines)
                lib = ctypes.CDLL(str(path))
            _loaded[key] = lib
        return lib
