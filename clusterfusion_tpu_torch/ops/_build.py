"""Build and load the port's CUDA kernels (no JAX counterpart).

Every ``*.cu`` under ``clusterfusion_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface,
which is loaded with ``ctypes``.  Each source compiles in its own ``nvcc``
process, all started together, and one link step joins the objects.  The
library's name carries a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads what is already built.  The
build happens at first use, never at import, and a failure raises.

The output goes to ``build/`` beside the package (listed in
``.gitignore``).  Sources include no PyTorch header: the build takes
seconds, where ``torch.utils.cpp_extension.load`` takes minutes.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "clusterfusion_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function: (argtypes, restype)
SIGNATURES = {
    "cf_flash_prefill": ([_P] * 4 + [_I] * 7 + [_P], _I),
    "cf_stack_scratch_floats": ([_I] * 7, ctypes.c_longlong),
    "cf_decoder_stack": ([_P] * 17 + [_I] * 11
                         + [_F, _I, _I, ctypes.POINTER(_I), _P], _I),
    "cf_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    them into ``build/.../libcftorch_<hash>.so``; returns its path."""
    srcs = _sources()
    out = BUILD_DIR / f"libcftorch_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, _, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc failed on {src.name}:\n{log}")
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp_lib = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared",
                *[str(o) for _, o, _ in procs], "-o", str(tmp_lib)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, out)       # atomic: concurrent builds agree
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib().cf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
