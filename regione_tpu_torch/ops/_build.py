"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All `regione_tpu_torch/csrc/*.cu` compile into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  Each
source compiles to an object in its own nvcc process, all started
together, then one nvcc links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu     # each, at once
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/kernels/libregione_<hash>.so *.o

The library is named by a hash of the sources' contents and the flags, so an
edit rebuilds and an unchanged tree reuses the last build.  It is built at
first use, never at import: the CPU tests import every module of the port on
machines with no nvcc.  Each C entry takes device pointers and the stream as
`c_void_p` (a plain int would be cut to 32 bits), launches on PyTorch's
current stream, allocates nothing, and returns cudaGetLastError()
(`ops.launch.launch` raises on a non-zero code).
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
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points (csrc/*.cu)
_SIGNATURES = {
    "regione_attention_tma_fwd": [_P] * 10 + [_I] * 6 + [_F, _P],
    "regione_partition_fwd": [_P, _P, _F, _I, _I, _I, _I, _I, _L, _P, _P],
    "regione_adaln_fwd": [_P] * 8 + [_I] * 3 + [_P],
    "regione_qk_norm_rope_fwd": [_P] * 6 + [_I] * 3 + [_P],
    "regione_gelu_pack_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "regione_swiglu_pack_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "regione_kv_quant_store_fwd": [_P] * 4 + [_I] * 4 + [_P],
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
    """Compile csrc/*.cu into one .so unless the same sources are built:
    one nvcc per source, all at once, then the link.  Returns (path,
    compiler output: `-Xptxas -v` reports each kernel's registers, shared
    memory and spills; empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = [proc.communicate()[0] for _, proc in procs]   # wait for all
    for (cmd, proc), text in zip(procs, log):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, "".join(log) + res.stdout + res.stderr


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
