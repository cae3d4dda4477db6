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
_LL = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
# C signature of every exported function: (argtypes, restype)
SIGNATURES = {
    "cf_flash_prefill": ([_P] * 4 + [_I] * 7 + [_LL, _LL, _P], _I),
    "cf_stack_scratch_floats": ([_I] * 9, ctypes.c_longlong),
    "cf_decoder_stack": ([_P] * 17 + [_I] * 11
                         + [_F, _I, _I, ctypes.POINTER(_I), _P, _P], _I),
    "cf_verify_scratch_floats": ([_I] * 8, ctypes.c_longlong),
    "cf_verify_stack": ([_P] * 17 + [_I] * 12
                        + [_F, _I, _I, ctypes.POINTER(_I), _P], _I),
    "cf_paged_scratch_floats": ([_I] * 7, ctypes.c_longlong),
    "cf_paged_attention": ([_P] * 9 + [_I] * 9 + [_P], _I),
    "cf_paged_layer_scratch_floats": ([_I] * 7, ctypes.c_longlong),
    "cf_paged_decoder_layer": ([_P] * 17 + [_I] * 13
                               + [_F, _I, ctypes.POINTER(_I), _P], _I),
    "cf_fused_ffn_scratch_floats": ([_I] * 2, ctypes.c_longlong),
    "cf_fused_ffn_plan": ([_I, _I, ctypes.POINTER(_I)], _I),
    "cf_fused_ffn": ([_P] * 8 + [_I] * 3 + [_F, _P, ctypes.POINTER(_I), _P],
                     _I),
    "cf_mla_scratch_floats": ([_I] * 7, ctypes.c_longlong),
    "cf_mla_decode": ([_P] * 13 + [_I] * 10 + [_F, _F, _I, _I,
                                               ctypes.POINTER(_I), _P], _I),
    "cf_rmsnorm": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
    "cf_gemv": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "cf_decoder_layer_scratch_floats": ([_I] * 2, ctypes.c_longlong),
    "cf_decoder_layer_plan": ([_I] * 5 + [ctypes.POINTER(_I)], _I),
    "cf_decoder_layer": ([_P] * 16 + [_I] * 10
                         + [_F, _I, _P, ctypes.POINTER(_I), _P], _I),
    "cf_error_string": ([_I], ctypes.c_char_p),
    "cf_comm_preload": ([], _I),
    "cf_comm_buffer_bytes": ([_I, _LL], _LL),
    "cf_comm_alloc": ([_I, _LL, _PP], _I),
    "cf_comm_free": ([_P], _I),
    "cf_comm_ipc_handle_bytes": ([], _I),
    "cf_comm_ipc_handle": ([_P, _P], _I),
    "cf_comm_ipc_open": ([_I, _P, _PP], _I),
    "cf_comm_ipc_close": ([_P], _I),
    "cf_device_bus_id": ([_I, ctypes.c_char_p, _I], _I),
    "cf_device_by_bus_id": ([ctypes.c_char_p, ctypes.POINTER(_I)], _I),
    "cf_can_access_peer": ([_I, _I, ctypes.POINTER(_I)], _I),
    "cf_comm_err_alloc": ([_PP, _PP], _I),
    "cf_comm_err_free": ([_P], _I),
    "cf_comm_new": ([_I, _I, _LL, _PP, _P], _P),
    "cf_comm_delete": ([_P], None),
    "cf_allreduce": ([_P, _P, _P, _LL, _I, _P], _I),
    "cf_allgather": ([_P, _P, _P, _LL, _P], _I),
    "cf_allreduce_loopback": ([_P, _PP, _PP, _LL, _I, _P], _I),
    "cf_allgather_loopback": ([_P, _PP, _PP, _LL, _P], _I),
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


def _sources(csrc: Path):
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    return srcs


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/*.cu`` (one nvcc per source, in parallel) and link
    them into ``build_dir/libcftorch_<hash>.so``; returns its path."""
    srcs = _sources(csrc)
    out = build_dir / f"libcftorch_{_digest(csrc)}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-c", str(src),
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


def load(path: Path) -> ctypes.CDLL:
    """A built library with every entry point's C signature set."""
    handle = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = lib().cf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
