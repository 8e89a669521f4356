"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All `regione_tpu_torch/csrc/*.cu` compile into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/libregione_<hash>.so csrc/*.cu

The library is named by a hash of the sources' contents and the flags, so an
edit rebuilds and an unchanged tree reuses the last build.  It is built at
first use, never at import: the CPU tests import every module of the port on
machines with no nvcc.  Each C entry takes device pointers and the stream as
`c_void_p` (a plain int would be cut to 32 bits), launches on PyTorch's
current stream, allocates nothing, and returns cudaGetLastError(); `check`
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu)
_SIGNATURES = {
    "regione_attention_fwd": [_P] * 10 + [_I] * 6 + [_F, _P],
    "regione_partition_fwd": [_P, _P, _F, _I, _I, _I, _I, _P, _P],
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin or PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
        "port's CUDA kernels are built from regione_tpu_torch/csrc at first "
        "use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libregione_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile csrc/*.cu into one .so unless the same sources are built.
    Returns (path, compiler output: `-Xptxas -v` reports each kernel's
    registers, shared memory and spills; empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
