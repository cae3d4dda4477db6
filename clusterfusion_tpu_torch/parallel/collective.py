"""Collectives over a mesh axis (twin of
``clusterfusion_tpu/parallel/collective.py``).

``Stage`` names where in the fused layer a collective sits (the
reference's stage taxonomy); ``cluster_reduce`` is the all-reduce (sum, in
float32 whatever the input's dtype, with a ReLU after the sum at
``Stage.FFN``) and ``cluster_gather`` the all-gather along axis 0 (shards
concatenated in rank order).  ``psum`` and ``pmax`` are the counterparts of
``jax.lax.psum`` / ``jax.lax.pmax`` that the sequence-parallel merge uses.

Two backends, as in JAX:

- ``"xla"``, and ``"auto"``, which resolves to it as JAX's does: one
  ``torch.distributed`` collective (NCCL on the card, gloo on the CPU) over
  the axis's sub-group.
- ``"pallas"``: kernels 13 and 14 of the kernel table (``csrc/collective.cu``).
  Each rank stores its data into every peer's symmetric buffer over NVLink
  (CUDA IPC) and the all-reduce adds the ranks' values in rank order
  0..N-1, so every rank gets the same bits.  A :class:`Communicator` per
  axis group owns the buffers; :func:`communicator` builds it at first use
  and keeps it.  On CPU tensors the plain versions run instead:
  :func:`all_reduce_plain` gathers every rank's tensor and adds them in the
  kernel's order; :func:`all_gather_plain` concatenates them.

On an axis of size 1 no collective runs: the value is its own sum, as
``psum`` over a size-1 axis is.

One card can hold N virtual ranks of an axis: :class:`LoopbackComm` owns N
symmetric buffers on it and runs both kernels for all N ranks in one
launch; its :meth:`LoopbackComm.mesh` gives each rank a ``Mesh`` whose
group is that rank's :class:`Communicator`, so that N calls of a rank's
step, each on its own CUDA stream, run against each other on one card.
"""

from __future__ import annotations

import ctypes
import enum
import socket
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from clusterfusion_tpu_torch.ops import _build
from clusterfusion_tpu_torch.ops._support import round_up
from clusterfusion_tpu_torch.parallel.mesh import AXES, Mesh

#: Reduces of kernel 13 ("all_reduce") and launches of kernel 14
#: ("all_gather"): here one a launch, and in ``fused_decoder_stack`` (mode
#: 5) the 2L reduces of a step, which run inside kernel 7's own launches
#: (pushed by its O-projection and down-projection products, summed by the
#: norms after them) and launch nothing of their own.
launches: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}

#: Bytes of one rank's slot in a symmetric buffer; a larger call runs in
#: pieces of this size, one launch each.
SLOT_BYTES = 1 << 20
#: Most ranks one axis may have (``CF_MAX_RANKS`` in ``csrc/collective.cuh``).
MAX_RANKS = 8


class Stage(enum.Enum):
    """Where in the fused decoder layer the collective sits (the
    reference's ``Stage`` enum)."""

    LINEAR = "linear"            # partial-QKV / down-projection all-reduce
    ATTN = "attn"                # head-output all-reduce
    FFN = "ffn"                  # down-proj all-reduce + ReLU
    LINEAR_DEEPSEEK = "linear_deepseek"
    ATTN_DEEPSEEK = "attn_deepseek"
    QUK_DEEPSEEK = "quk_deepseek"   # all-gather


def _resolve_backend(backend: str) -> str:
    if backend == "auto":
        return "xla"
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown collective backend {backend!r}")
    return backend


# --------------------------------------------------------------------------
# Kernels 13 and 14: communicators over symmetric buffers
# --------------------------------------------------------------------------


def _ptr_out(fn, *args) -> int:
    out = ctypes.c_void_p()
    _build.check(fn(*args, ctypes.byref(out)), fn.__name__)
    return out.value


class Communicator:
    """One rank's view of the symmetric buffers of one mesh axis: what
    kernels 13 and 14 need (see ``csrc/collective.cu``).

    ``bufs[p]`` is rank p's buffer as this process maps it; ``err_host`` /
    ``err_dev`` the host and device addresses of the mapped error word the
    kernels write when a wait times out; ``release`` frees what this
    communicator owns (None where another object owns it)."""

    def __init__(self, rank: int, size: int, device: int, bufs: Sequence[int],
                 err_host: int, err_dev: int,
                 release: Optional[Callable[[], None]] = None):
        if not 1 <= size <= MAX_RANKS:
            raise ValueError(f"an axis of {size} ranks: kernels 13 and 14 "
                             f"take at most {MAX_RANKS}")
        lib = _build.lib()
        with torch.cuda.device(device):
            _build.check(lib.cf_comm_preload(), "loading kernels 13 and 14")
        arr = (ctypes.c_void_p * size)(*bufs)
        self.handle = lib.cf_comm_new(rank, size, SLOT_BYTES, arr, err_dev)
        if not self.handle:
            raise ValueError(f"bad communicator: rank {rank} of {size}")
        self.rank, self.size, self.device = rank, size, device
        self._err_host = err_host
        self._release = release

    @classmethod
    def over_group(cls, group, rank: int, size: int) -> "Communicator":
        """Build rank ``rank``'s communicator over a process group of
        ``size`` ranks, one process per card of one host: allocate this
        rank's buffer, exchange the IPC handles over ``group``, open every
        peer's buffer and hold a barrier.  Raises where a peer's card is not
        visible, not on this host, or not reachable by peer access."""
        if dist.get_rank(group) != rank or dist.get_world_size(group) != size:
            raise ValueError("the mesh coordinates disagree with the group")
        lib = _build.lib()
        dev = torch.cuda.current_device()
        own = _ptr_out(lib.cf_comm_alloc, dev,
                       lib.cf_comm_buffer_bytes(size, SLOT_BYTES))
        opened: List[int] = []
        err_host = err_dev = None

        def release():
            for p in opened:
                lib.cf_comm_ipc_close(p)
            if err_host:
                lib.cf_comm_err_free(err_host)
            lib.cf_comm_free(own)

        try:
            handle = ctypes.create_string_buffer(
                lib.cf_comm_ipc_handle_bytes())
            _build.check(lib.cf_comm_ipc_handle(own, ctypes.addressof(handle)),
                         "cudaIpcGetMemHandle")
            bus = ctypes.create_string_buffer(32)
            _build.check(lib.cf_device_bus_id(dev, bus, 32),
                         "cudaDeviceGetPCIBusId")
            info = (handle.raw, bus.value, socket.gethostname())
            infos: List[object] = [None] * size
            dist.all_gather_object(infos, info, group=group)
            bufs = []
            for p, (h, peer_bus, host) in enumerate(infos):
                if p == rank:
                    bufs.append(own)
                    continue
                if host != info[2]:
                    raise RuntimeError(
                        f"kernels 13 and 14 need every rank of an axis on one "
                        f"host: rank {p} is on {host}, rank {rank} on {info[2]}")
                peer_dev = ctypes.c_int(-1)
                if lib.cf_device_by_bus_id(peer_bus, ctypes.byref(peer_dev)):
                    raise RuntimeError(
                        f"rank {p}'s card {peer_bus.decode()} is not visible "
                        f"to rank {rank} (card {bus.value.decode()}): kernels "
                        "13 and 14 map it through CUDA IPC")
                if peer_dev.value != dev:
                    can = ctypes.c_int(0)
                    _build.check(lib.cf_can_access_peer(dev, peer_dev.value,
                                                        ctypes.byref(can)),
                                 "cudaDeviceCanAccessPeer")
                    if not can.value:
                        raise RuntimeError(
                            f"card {bus.value.decode()} (rank {rank}) cannot "
                            f"access card {peer_bus.decode()} (rank {p}) as a "
                            "peer: kernels 13 and 14 need peer access between "
                            "the cards of an axis")
                ptr = ctypes.c_void_p()
                _build.check(lib.cf_comm_ipc_open(dev, h, ctypes.byref(ptr)),
                             f"cudaIpcOpenMemHandle of rank {p}'s buffer")
                opened.append(ptr.value)
                bufs.append(ptr.value)
            err_host, err_dev = _err_word(lib)
            comm = cls(rank, size, dev, bufs, err_host, err_dev, release)
        except BaseException:
            release()
            raise
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[dev])
        else:
            dist.barrier(group=group)
        return comm

    def close(self) -> None:
        """Free what this communicator owns (after the card is idle)."""
        if self.handle:
            _build.lib().cf_comm_delete(self.handle)
            self.handle = None
            if self._release is not None:
                torch.cuda.synchronize(self.device)
                self._release()

    def error(self) -> int:
        """The error word: 0, or 0x10000 | rank << 8 | peer of a wait that
        timed out (of a call that has finished on the card)."""
        return ctypes.c_int.from_address(self._err_host).value

    def raise_on_error(self) -> None:
        code = self.error()
        if code:
            raise RuntimeError(
                f"kernels 13/14: rank {(code >> 8) & 0xff} waited more than "
                f"2 s for the flag of rank {code & 0xff} (a rank died, or the "
                "ranks' calls differ); the communicator is unusable")

    def check(self) -> None:
        """Synchronise the card, then raise on the error word."""
        torch.cuda.synchronize(self.device)
        self.raise_on_error()

    def _check_device(self, x: torch.Tensor) -> None:
        if x.device.type != "cuda" or x.device.index != self.device:
            raise ValueError(f"a tensor on {x.device}; this communicator's "
                             f"card is cuda:{self.device}")

    def all_reduce(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """Kernel 13: the sum over the ranks of float32 ``x`` (the same shape
        on every rank), added in rank order, ReLU after the sum when
        ``relu``; a new tensor of x's shape."""
        self._check_device(x)
        src, n = _f32_words(x)
        out = torch.empty_like(src)
        lib = _build.lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        chunk = SLOT_BYTES // 4
        with torch.cuda.device(x.device):
            for lo in range(0, src.numel(), chunk):
                m = min(chunk, src.numel() - lo)
                _build.check(lib.cf_allreduce(
                    self.handle, src.data_ptr() + 4 * lo,
                    out.data_ptr() + 4 * lo, m, int(relu), stream),
                    "all_reduce (kernel 13)")
                launches["all_reduce"] += 1
        self.raise_on_error()
        return out[:n].view(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel 14: every rank's ``x`` (the same shape and dtype on every
        rank) concatenated along axis 0 in rank order."""
        self._check_device(x)
        src, nbytes = _byte_rows(x)
        row = src.numel()
        out = torch.empty((self.size, row), dtype=torch.uint8,
                          device=x.device)
        lib = _build.lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            for lo in range(0, row, SLOT_BYTES):
                m = min(SLOT_BYTES, row - lo)
                dst = out if m == row else torch.empty(
                    (self.size, m), dtype=torch.uint8, device=x.device)
                _build.check(lib.cf_allgather(
                    self.handle, src.data_ptr() + lo, dst.data_ptr(), m // 16,
                    stream), "all_gather (kernel 14)")
                launches["all_gather"] += 1
                if dst is not out:
                    out[:, lo:lo + m] = dst
        self.raise_on_error()
        return _from_byte_rows(out, nbytes, x)


def _err_word(lib):
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    _build.check(lib.cf_comm_err_alloc(ctypes.byref(host), ctypes.byref(dev)),
                 "cudaHostAlloc of the error word")
    return host.value, dev.value


def _f32_words(x: torch.Tensor):
    """(x flat, padded to a multiple of 4 floats and 16-byte aligned, n)."""
    if x.dtype != torch.float32:
        raise ValueError(f"kernel 13 sums float32, got {x.dtype}")
    flat = x.contiguous().reshape(-1)
    n = flat.numel()
    if n % 4 or flat.data_ptr() % 16:
        pad = torch.zeros(round_up(max(n, 1), 4), dtype=torch.float32,
                          device=x.device)
        pad[:n] = flat
        flat = pad
    return flat, n


def _byte_rows(x: torch.Tensor):
    """(x's bytes, padded to a multiple of 16 and 16-byte aligned, their
    count)."""
    if x.dim() == 0:
        raise ValueError("all_gather needs an axis 0")
    b = x.contiguous().reshape(-1).view(torch.uint8)
    nbytes = b.numel()
    if nbytes % 16 or b.data_ptr() % 16 or nbytes == 0:
        pad = torch.zeros(round_up(max(nbytes, 1), 16), dtype=torch.uint8,
                          device=x.device)
        pad[:nbytes] = b
        b = pad
    return b, nbytes


def _from_byte_rows(rows: torch.Tensor, nbytes: int, x: torch.Tensor):
    """[size, padded bytes] rows -> the shards concatenated along axis 0."""
    if rows.shape[1] != nbytes:
        rows = rows[:, :nbytes].contiguous()
    shape = (rows.shape[0] * x.shape[0],) + tuple(x.shape[1:])
    return rows.reshape(-1).view(x.dtype).reshape(shape)


class LoopbackComm:
    """``size`` virtual ranks of one mesh axis on one card: ``size``
    symmetric buffers there, one error word, and one
    :class:`Communicator` per virtual rank (``ranks[r]``), whose peers are
    the other buffers of the same card.

    :meth:`all_reduce` / :meth:`all_gather` run kernels 13 and 14 for every
    virtual rank in one launch (the grid held to one wave, since the ranks'
    blocks wait for each other).  A rank's own :class:`Communicator`, in
    the group of :meth:`mesh`, launches its part alone, so that the ranks'
    calls, each on its own CUDA stream, meet on the card.  Those calls come
    from one host thread, so any kernel the ranks' path launches for the
    first time in the process must be loaded before a rank spins on the
    card: CUDA loads kernels lazily, and a load may wait for the card to go
    idle.  Kernels 13 and 14 are loaded when a communicator is made; run
    the path once without collectives first (or set
    ``CUDA_MODULE_LOADING=EAGER``)."""

    def __init__(self, size: int, device=None):
        lib = _build.lib()
        dev = torch.device("cuda" if device is None else device)
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        nbytes = lib.cf_comm_buffer_bytes(size, SLOT_BYTES)
        self._bufs: List[int] = []
        self._err = None
        try:
            for _ in range(size):
                self._bufs.append(_ptr_out(lib.cf_comm_alloc, index, nbytes))
            self._err = _err_word(lib)
            self.ranks = [Communicator(r, size, index, self._bufs, *self._err)
                          for r in range(size)]
        except BaseException:
            self._free()
            raise
        self.size, self.device = size, index

    def _free(self) -> None:
        lib = _build.lib()
        for p in self._bufs:
            lib.cf_comm_free(p)
        self._bufs = []
        if self._err:
            lib.cf_comm_err_free(self._err[0])
            self._err = None

    def close(self) -> None:
        """Free the buffers (after the card is idle)."""
        torch.cuda.synchronize(self.device)
        for c in self.ranks:
            c.close()
        self._free()

    def check(self) -> None:
        self.ranks[0].check()

    def mesh(self, rank: int, axis_name: str = "tp") -> Mesh:
        """Virtual rank ``rank``'s mesh: ``size`` ranks on ``axis_name``
        (1 on every other axis), its group the rank's communicator."""
        shape = {a: 1 for a in AXES}
        coords = {a: 0 for a in AXES}
        groups: Dict[str, Optional[object]] = {a: None for a in AXES}
        shape[axis_name], coords[axis_name] = self.size, rank
        if self.size > 1:
            groups[axis_name] = self.ranks[rank]
        return Mesh(shape=shape, coords=coords, groups=groups)

    def _launch(self, fn, xs, outs, n_units, *extra) -> None:
        lib = _build.lib()
        dev = xs[0].device
        for t in xs:
            self.ranks[0]._check_device(t)
        stream = torch.cuda.current_stream(dev).cuda_stream
        xp = (ctypes.c_void_p * self.size)(*[t.data_ptr() for t in xs])
        op = (ctypes.c_void_p * self.size)(*[t.data_ptr() for t in outs])
        with torch.cuda.device(dev):
            _build.check(fn(self.ranks[0].handle, xp, op, n_units, *extra,
                            stream), fn.__name__)

    def all_reduce(self, xs: Sequence[torch.Tensor],
                   relu: bool = False) -> List[torch.Tensor]:
        """Kernel 13 for every virtual rank in one launch: rank r's float32
        ``xs[r]``, all of one shape; returns each rank's sum."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} inputs for {self.size} ranks")
        words = [_f32_words(x) for x in xs]
        n = words[0][1]
        srcs = [w[0] for w in words]
        outs = [torch.empty_like(s) for s in srcs]
        if srcs[0].numel() * 4 > SLOT_BYTES:
            raise ValueError(f"a loopback call takes one slot of {SLOT_BYTES} "
                             "bytes")
        self._launch(_build.lib().cf_allreduce_loopback, srcs, outs,
                     srcs[0].numel(), int(relu))
        launches["all_reduce"] += 1
        self.ranks[0].raise_on_error()
        return [o[:n].view(xs[0].shape) for o in outs]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Kernel 14 for every virtual rank in one launch."""
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} inputs for {self.size} ranks")
        rows = [_byte_rows(x) for x in xs]
        nbytes = rows[0][1]
        srcs = [r[0] for r in rows]
        if srcs[0].numel() > SLOT_BYTES:
            raise ValueError(f"a loopback call takes one slot of {SLOT_BYTES} "
                             "bytes")
        outs = [torch.empty((self.size, srcs[0].numel()), dtype=torch.uint8,
                            device=s.device) for s in srcs]
        self._launch(_build.lib().cf_allgather_loopback, srcs, outs,
                     srcs[0].numel() // 16)
        launches["all_gather"] += 1
        self.ranks[0].raise_on_error()
        return [_from_byte_rows(o, nbytes, xs[0]) for o in outs]


_COMMS: Dict[object, Communicator] = {}


def communicator(mesh: Mesh, axis_name: str) -> Communicator:
    """This rank's communicator of ``axis_name`` (None on an axis of size
    1): a loopback mesh's own, or the one over the axis's process group,
    built at first use and kept."""
    group = mesh.groups[axis_name]
    if group is None or isinstance(group, Communicator):
        return group
    comm = _COMMS.get(group)
    if comm is None:
        comm = Communicator.over_group(group, mesh.coords[axis_name],
                                       mesh.shape[axis_name])
        _COMMS[group] = comm
    return comm


def release_communicators() -> None:
    """Close every communicator :func:`communicator` built (call before the
    process groups are destroyed)."""
    while _COMMS:
        _COMMS.popitem()[1].close()


# --------------------------------------------------------------------------
# Plain versions (CPU tensors; and the card tests' yardstick)
# --------------------------------------------------------------------------


def _sum_in_rank_order(parts: Sequence[torch.Tensor],
                       relu: bool) -> torch.Tensor:
    acc = parts[0].clone()
    for p in parts[1:]:
        acc.add_(p)
    return torch.relu(acc) if relu else acc


def all_reduce_plain(x: torch.Tensor, group, relu: bool = False):
    """Kernel 13's plain version: every rank's tensor gathered over
    ``group``, then added in rank order 0..N-1 (the kernel's order), ReLU
    after the sum when ``relu``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return _sum_in_rank_order(parts, relu)


def all_gather_plain(x: torch.Tensor, group):
    """Kernel 14's plain version: every rank's tensor, concatenated along
    axis 0 in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def all_reduce_loopback_plain(xs: Sequence[torch.Tensor],
                              relu: bool = False) -> List[torch.Tensor]:
    """:meth:`LoopbackComm.all_reduce` in plain PyTorch."""
    out = _sum_in_rank_order(xs, relu)
    return [out] * len(xs)


def all_gather_loopback_plain(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:meth:`LoopbackComm.all_gather` in plain PyTorch."""
    out = torch.cat(list(xs), dim=0)
    return [out] * len(xs)


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------


def _process_group(mesh: Mesh, axis_name: str):
    group = mesh.groups[axis_name]
    if isinstance(group, Communicator):
        raise ValueError("a loopback mesh has no process group: only "
                         "backend='pallas' runs on it, on the card")
    return group


def _all_reduce(x: torch.Tensor, axis_name: str, mesh: Mesh,
                op) -> torch.Tensor:
    """``op`` over ``axis_name`` into a new tensor (``x`` is not changed);
    ``x`` itself on an axis of size 1."""
    group = _process_group(mesh, axis_name)
    if group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, axis_name: str, *, mesh: Mesh) -> torch.Tensor:
    """Sum over ``axis_name``."""
    return _all_reduce(x, axis_name, mesh, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis_name: str, *, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum over ``axis_name``."""
    return _all_reduce(x, axis_name, mesh, dist.ReduceOp.MAX)


def pallas_all_reduce(x: torch.Tensor, axis_name: str, mesh: Mesh,
                      relu: bool = False) -> torch.Tensor:
    """Float32 sum over ``axis_name`` (longer than 1) by kernel 13 (a CUDA
    tensor) or its plain version (a CPU tensor), ReLU after the sum when
    ``relu``."""
    if x.device.type == "cpu":
        return all_reduce_plain(x, _process_group(mesh, axis_name), relu)
    return communicator(mesh, axis_name).all_reduce(x, relu)


def cluster_reduce(x: torch.Tensor, axis_name: str,
                   stage: Stage = Stage.LINEAR, backend: str = "auto", *,
                   mesh: Mesh) -> torch.Tensor:
    """All-reduce (sum) over ``axis_name`` in float32, returned in x's
    dtype; ``Stage.FFN`` applies a ReLU to the sum.  On an axis of size 1
    the float32 round trip is exact and is skipped."""
    relu = stage == Stage.FFN
    pallas = _resolve_backend(backend) == "pallas"
    if mesh.groups[axis_name] is not None:
        if pallas:
            return pallas_all_reduce(x.float(), axis_name, mesh,
                                     relu).to(x.dtype)
        x = _all_reduce(x.float(), axis_name, mesh,
                        dist.ReduceOp.SUM).to(x.dtype)
    return torch.relu(x) if relu else x


def cluster_gather(x: torch.Tensor, axis_name: str,
                   stage: Stage = Stage.QUK_DEEPSEEK, backend: str = "auto",
                   *, mesh: Mesh) -> torch.Tensor:
    """All-gather over ``axis_name`` along axis 0, shards concatenated in
    rank order: kernel 14 (or its plain version on CPU tensors) with
    ``backend="pallas"``."""
    del stage
    pallas = _resolve_backend(backend) == "pallas"
    if mesh.groups[axis_name] is None:
        return x
    if pallas and x.device.type == "cuda":
        return communicator(mesh, axis_name).all_gather(x)
    group = _process_group(mesh, axis_name)
    if pallas:
        return all_gather_plain(x, group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis_name])]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=0)
