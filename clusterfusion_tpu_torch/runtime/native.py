"""ctypes binding of the host page scheduler (twin of
``clusterfusion_tpu/runtime/native.py``).

``PagedKVScheduler`` drives ``clusterfusion_tpu_torch/native/kv_runtime.cpp``,
the port's own copy of the JAX package's C++ scheduler.  The library is
built with ``g++`` at first use (never at import) into
``build/clusterfusion_tpu_torch/``, named by a hash of the source, so an
edited source rebuilds and concurrent builds agree.  This is host code:
it runs wherever ``g++`` does, with or without a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from clusterfusion_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parents[1] / "native" / "kv_runtime.cpp"
_LOCK = threading.Lock()
_LIB = None


def _build_lib() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libkv_runtime_{digest}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(so_path.name + f".tmp{os.getpid()}")
    res = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o",
         str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name}:\n{res.stderr}")
    os.replace(tmp, so_path)       # atomic: concurrent builds agree
    return so_path


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_lib()))
            i32, i64, p = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
            I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            sigs = {
                "cf_pool_create": ([i32, i32, i32], p),
                "cf_pool_destroy": ([p], None),
                "cf_pool_free_pages": ([p], i32),
                "cf_pool_num_requests": ([p], i32),
                "cf_pool_set_window": ([p, i32], i32),
                "cf_request_add": ([p, i64, i32], i32),
                "cf_request_release": ([p, i64], i32),
                "cf_request_len": ([p, i64], i32),
                "cf_request_pages": ([p, i64, I32P], i32),
                "cf_prepare_batch": ([p, i32, I64P, I32P, I32P, I32P, I32P],
                                     i32),
                "cf_commit_batch": ([p], i32),
                "cf_discard_batch": ([p], i32),
            }
            for name, (argtypes, restype) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
    return _LIB


class PagedKVScheduler:
    """Page allocator + continuous-batching scheduler over the native pool.

    Produces exactly the (block_table, seq_lens, positions) operands of
    ``llama_decoder_layer_paged`` and ``paged_attention``; page 0 is the
    reserved NULL page for batch-padding rows.
    """

    def __init__(self, num_pages: int, page_size: int,
                 max_pages_per_req: int):
        self._lib = _load()
        self._h = self._lib.cf_pool_create(num_pages, page_size,
                                           max_pages_per_req)
        if not self._h:
            raise ValueError("bad pool geometry")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_pages_per_req = max_pages_per_req
        # last decodable token index: one page slot is always reserved for
        # the token being decoded
        self.max_tokens = max_pages_per_req * page_size - 1

    def set_window(self, window_tokens: int) -> int:
        """Rolling-buffer mode for a token window: installs the minimal
        safe page cap ``ceil(window/page_size) + 1`` (the +1 is the filling
        tail page) through :meth:`set_window_pages` and returns it.  Must
        be called before any request is added."""
        if window_tokens <= 0:
            raise ValueError(f"window_tokens must be > 0, got "
                             f"{window_tokens}")
        window_pages = -(-window_tokens // self.page_size) + 1
        self.set_window_pages(window_pages, _window_tokens=window_tokens)
        return window_pages

    def set_window_pages(self, window_pages: int,
                         _window_tokens: int | None = None) -> None:
        """Rolling-buffer mode: cap each request's real pages at
        ``window_pages``; block-table slots below the window hold the NULL
        page 0, which the window-aware kernels never read.  Must be set
        before any request is added (0 turns it off).

        The token window must satisfy ``window <= (window_pages - 1) *
        page_size + 1``, or recycling overwrites KV rows still in the
        window; pass ``_window_tokens`` to have that checked
        (:meth:`set_window` does)."""
        if _window_tokens is not None and \
                _window_tokens > (window_pages - 1) * self.page_size + 1:
            raise ValueError(
                f"window_pages={window_pages} unsafe for a "
                f"{_window_tokens}-token window at page_size="
                f"{self.page_size}: recycling would overwrite in-window KV "
                f"(need >= {-(-_window_tokens // self.page_size) + 1})")
        if self._lib.cf_pool_set_window(self._h, window_pages) != 0:
            raise ValueError("set_window_pages: bad value or requests "
                             "already present")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cf_pool_destroy(self._h)
            self._h = None

    @property
    def free_pages(self) -> int:
        return self._lib.cf_pool_free_pages(self._h)

    @property
    def num_requests(self) -> int:
        return self._lib.cf_pool_num_requests(self._h)

    def add(self, req_id: int, prompt_len: int) -> None:
        rc = self._lib.cf_request_add(self._h, req_id, prompt_len)
        if rc == -2:
            raise ValueError(
                f"prompt of {prompt_len} tokens exceeds request capacity "
                f"{self.max_tokens}")
        if rc != 0:
            raise ValueError(f"duplicate or invalid request {req_id}")

    def release(self, req_id: int) -> None:
        self._lib.cf_request_release(self._h, req_id)

    def request_len(self, req_id: int) -> int:
        return self._lib.cf_request_len(self._h, req_id)

    def request_pages(self, req_id: int) -> np.ndarray:
        out = np.zeros(self.max_pages_per_req, np.int32)
        n = self._lib.cf_request_pages(self._h, req_id, out)
        if n < 0:
            raise KeyError(req_id)
        return out[:n]

    def prepare_batch(self, max_batch: int) -> Tuple[
            np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """-> (req_ids [B], block_table [B, max_pages], seq_lens [B],
        positions [B], newly_admitted [B] bool).  B may be 0."""
        ids = np.zeros(max_batch, np.int64)
        table = np.zeros((max_batch, self.max_pages_per_req), np.int32)
        lens = np.zeros(max_batch, np.int32)
        poss = np.zeros(max_batch, np.int32)
        fresh = np.zeros(max_batch, np.int32)
        B = self._lib.cf_prepare_batch(self._h, max_batch, ids,
                                       table.reshape(-1), lens, poss, fresh)
        if B < 0:
            raise ValueError(f"bad max_batch {max_batch}")
        return (ids[:B], table[:B], lens[:B], poss[:B],
                fresh[:B].astype(bool))

    def commit_batch(self) -> None:
        self._lib.cf_commit_batch(self._h)

    def discard_batch(self) -> None:
        """Abandon the last prepared batch without advancing lengths."""
        self._lib.cf_discard_batch(self._h)
