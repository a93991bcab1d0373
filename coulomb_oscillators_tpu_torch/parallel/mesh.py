"""Particle sharding over a 1D device mesh, one process per device.

Twin of ``coulomb_oscillators_tpu/parallel/mesh.py``.  The reference is
single-controller: one process, ``shard_map`` over a ``jax.sharding.Mesh``.
The port is SPMD: every device has its own process (a *rank*), the ranks
form a ``torch.distributed`` process group, and the collectives are called
explicitly.  :class:`Mesh` is the twin of the reference's one-axis mesh: it
holds the rank count and this process's rank and device, it names the
group (the default one, never held: :func:`_rank_main` says why), and
its three collectives are the only place where the port calls
``torch.distributed``:

  * :meth:`Mesh.all_gather` (the reference's tiled ``all_gather``),
  * :meth:`Mesh.all_reduce_sum` (``psum``),
  * :meth:`Mesh.ring_shift` (``ppermute`` by k places around the ring).

Each goes through ``utils.graphs.collective``: inside the capture of a CUDA
graph it is a cut point between two captured segments, which every replay
of the step runs for real (the twin of a collective inside the reference's
jitted ``shard_map``).

:func:`spawn` starts the ranks (``torch.multiprocessing.spawn``) with a
file-store rendezvous in a temporary directory, so no TCP port is taken;
:func:`make_mesh` is called inside a rank and joins its group (also under
``torchrun``).

Device placement is explicit and never falls back:

  * ``device=None``: rank r takes ``cuda:r``; fewer CUDA devices than ranks
    raises;
  * ``device="cpu"``: every rank is a CPU process (the twin of the
    reference tests' virtual host-platform mesh);
  * ``share_device=True``: every rank uses the one device named: the
    virtual mesh on one card, the only way a single GPU runs several ranks.
    A caller asks for it; the code never chooses it.

Backend: NCCL when every rank has a CUDA device of its own (also a single
rank on its card), gloo otherwise.  gloo moves CUDA tensors for a few
collectives only, so under gloo a CUDA tensor is staged through host memory
by each of the three methods, explicitly.

Collectives belong to a rank's main thread: issued from two threads they
interleave differently on different ranks and hang.  The Simulator's
background rebuild thread therefore never calls one.

Signatures keep the reference's parameters in the reference's order, so a
call written for it reads the same here.  Two of them carry nothing in the
port and are accepted only for that: ``axis`` (the mesh has the one axis,
and the collectives are methods of the mesh, not named by axis), here and
in ``fmm_shard`` and ``fmm_pshard``; and ``dim`` of
:func:`make_sharded_direct` and :func:`_local_direct` (the tensors' last
extent says it).

The sharded direct force (:func:`make_sharded_direct`) comes in the
reference's two schemes, all-gather and ring.  Its block-on-block force is
``ops.direct.direct_targets``: the Hopper direct kernel on CUDA tensors,
the plain chunked form on CPU tensors.
"""

from __future__ import annotations

import collections
import datetime
import os
import pickle
import tempfile
from typing import Callable

import torch
import torch.distributed as dist

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.ops import direct as D
from coulomb_oscillators_tpu_torch.utils import graphs

# seconds a collective may wait for its peers before the group fails
TIMEOUT = 120.0


class Mesh:
    """One axis of `ndev` ranks; this process is rank `rank` on `device`."""

    def __init__(self, ndev: int, rank: int, device: torch.device,
                 axis: str = "dp", backend: str = "gloo"):
        self.ndev = ndev
        self.rank = rank
        self.device = device
        self.axis = axis
        self.backend = backend
        # bytes of the tensors handed to each collective, and its calls
        self.bytes = collections.Counter()
        self.calls = collections.Counter()

    @property
    def group(self):
        """The process group: the default (world) group, looked up at every
        call and never held, so that ``destroy_process_group`` frees it
        whatever still holds the mesh (see :func:`_rank_main`)."""
        return dist.group.WORLD

    def _count(self, name: str, x: torch.Tensor) -> None:
        self.bytes[name] += x.numel() * x.element_size()
        self.calls[name] += 1

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """`x` as the backend takes it: contiguous, and under gloo in host
        memory."""
        x = x.contiguous()
        return x.cpu() if self.backend == "gloo" else x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' `x` [m, ...] concatenated along dim 0 in rank order:
        [ndev * m, ...] on every rank.  Under gloo a CUDA tensor goes
        through host memory."""
        return graphs.collective(self._all_gather, x,
                                 (self.ndev * x.shape[0], *x.shape[1:]))

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' `x`, a new tensor on every rank.  Under
        gloo a CUDA tensor goes through host memory."""
        return graphs.collective(self._all_reduce_sum, x, x.shape)

    def ring_shift(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """The `x` of rank (rank + k) % ndev: every rank sends its own to
        rank - k and receives from rank + k in one batch, so two ranks that
        exchange with each other do not deadlock.  The identity when k is a
        multiple of ndev.  Under gloo a CUDA tensor goes through host
        memory."""
        if (self.rank + k) % self.ndev == self.rank:
            return x
        return graphs.collective(lambda t: self._ring_shift(t, k), x,
                                 x.shape)

    # The collectives themselves.  Each public method above hands one to
    # ``utils.graphs.collective``, which runs it now, or, while a CUDA
    # graph is captured, makes it a cut point that every replay runs; so
    # the counters advance where a collective really runs (a capture's
    # warm-up, every replay, every eager call), never in a capture.

    def _all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all_gather", x)
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.ndev)]
        dist.all_gather(parts, w, group=self.group)
        return torch.cat(parts).to(x.device)

    def _all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        self._count("all_reduce_sum", x)
        w = self._wire(x)
        if w.data_ptr() == x.data_ptr():      # leave the input alone
            w = w.clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.group)
        return w.to(x.device)

    def _ring_shift(self, x: torch.Tensor, k: int) -> torch.Tensor:
        self._count("ring_shift", x)
        src = (self.rank + k) % self.ndev
        dst = (self.rank - k) % self.ndev
        w = self._wire(x)
        buf = torch.empty_like(w)
        ops = [dist.P2POp(dist.isend, w, dst, group=self.group),
               dist.P2POp(dist.irecv, buf, src, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return buf.to(x.device)

    def barrier(self) -> None:
        self.all_reduce_sum(torch.zeros(1, device=self.device))


def _rank_device(rank: int, ndev: int, device, share_device: bool):
    """The device of rank `rank` of `ndev` under the placement rules of
    the module docstring."""
    if share_device:
        if device is None:
            raise ValueError("share_device=True needs the device to share")
        return torch.device(device)
    if device is None:
        k = torch.cuda.device_count()
        if k < ndev:
            raise RuntimeError(f"{ndev} ranks need {ndev} CUDA devices: "
                               f"only {k} devices visible")
        return torch.device("cuda", rank)
    dev = torch.device(device)
    if dev.type != "cpu" and ndev > 1:
        raise ValueError(f"{ndev} ranks on the one device {dev} need "
                         f"share_device=True")
    return dev


def _backend(dev: torch.device, ndev: int, share_device: bool) -> str:
    own = dev.type == "cuda" and (not share_device or ndev == 1)
    return "nccl" if own else "gloo"


def _enter_rank(dev: torch.device, ndev: int) -> None:
    """Per-process settings of a rank: its CUDA device, or its share of the
    host's cores (the native host library is single-threaded)."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ndev))


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None,
              share_device: bool = False) -> Mesh:
    """This rank's :class:`Mesh`.  Inside a group (:func:`spawn`) it joins
    it; under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) it first
    initialises the group from the environment; in a lone process a mesh
    of one rank gets a group of its own.  Raises when `n_devices` is not
    the group's size, or when the placement cannot be had."""
    if dist.is_initialized():
        ndev, rank = dist.get_world_size(), dist.get_rank()
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        ndev, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        ndev, rank = n_devices or 1, 0
    if n_devices is not None and n_devices != ndev:
        raise ValueError(f"a mesh of {n_devices} was asked for inside a "
                         f"group of {ndev} ranks")
    dev = _rank_device(rank, ndev, device, share_device)
    backend = _backend(dev, ndev, share_device)
    if not dist.is_initialized():
        if ndev > 1 and "RANK" not in os.environ:
            raise RuntimeError(f"a mesh of {ndev} ranks needs {ndev} "
                               f"processes: start them with "
                               f"parallel.mesh.spawn or torchrun")
        _enter_rank(dev, ndev)
        timeout = datetime.timedelta(seconds=TIMEOUT)
        if "RANK" in os.environ:
            dist.init_process_group(backend, timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
    return Mesh(ndev, rank, dev, axis, dist.get_backend())


def _rank_main(rank: int, fn: Callable, ndev: int, tmp: str, device,
               share_device: bool, timeout: float, args: tuple) -> None:
    """One rank: join the group, run `fn`, write rank 0's result, wait for
    every rank, destroy the group.

    The group must be freed here, while the interpreter runs.  A gloo
    group's worker threads release each finished collective's tensors
    after the caller's wait returned, and freeing a tensor that Python has
    seen takes the GIL.  Were the group still alive when the interpreter
    finalises, that thread would be ended inside a noexcept destructor,
    and the process aborts ("terminate called without an active
    exception").  ``destroy_process_group`` drops the last reference
    (:attr:`Mesh.group` holds none, so a Simulator or any other object
    that still holds the mesh does not keep the group), and the group's
    destructor drains its queue and joins its threads before this function
    returns."""
    dev = _rank_device(rank, ndev, device, share_device)
    _enter_rank(dev, ndev)
    dist.init_process_group(
        _backend(dev, ndev, share_device),
        store=dist.FileStore(os.path.join(tmp, "store"), ndev), rank=rank,
        world_size=ndev, timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(ndev, device=device, share_device=share_device)
        out = fn(mesh, *args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n_devices: int, *args, device=None,
          share_device: bool = False, timeout: float = TIMEOUT):
    """Run ``fn(mesh, *args)`` on `n_devices` ranks, one process each, and
    return rank 0's result (anything that pickles; tensors on the host).
    `fn` is a module-level function.  The ranks meet through a file store
    in a temporary directory.  A rank that raises or dies fails the call
    (the other ranks are stopped).  The compiled libraries are built here,
    before the ranks start, so that no two ranks build one at once."""
    # an impossible placement raises here, before any process starts
    devs = [_rank_device(r, n_devices, device, share_device)
            for r in range(n_devices)]
    native.available()
    if devs[0].type == "cuda":
        from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
        p2p_cuda.library.get()
        p2p_cuda.library_2d.get()
        D.library.get()
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank_main, nprocs=n_devices, join=True,
            args=(fn, n_devices, tmp, device, share_device, timeout, args))
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _local_direct(tgt: torch.Tensor, src: torch.Tensor, eps2: float,
                  dim: int) -> torch.Tensor:
    """Force of all `src` on `tgt` rows (unscaled): the direct kernel on
    CUDA tensors, the plain chunked form on CPU tensors."""
    return D.direct_targets(tgt, src, eps2, 1.0)


def make_sharded_direct(mesh: Mesh, eps2: float, kappa: float, dim: int = 3,
                        scheme: str = "ring", axis: str = "dp") -> Callable:
    """Sharded direct force: this rank's rows pos_local [N/P, D] ->
    acc_local [N/P, D].

    N must be divisible by the mesh size (:func:`pad_to_multiple`); padded
    slots are parked far from the origin by the caller.  "allgather": each
    rank gathers all sources and computes their force on its rows.  "ring":
    the source block goes around the ring, one place a step, and each
    visiting block's force is added."""

    def allgather_impl(pos_local):
        src = mesh.all_gather(pos_local)
        return kappa * _local_direct(pos_local, src, eps2, dim)

    def ring_impl(pos_local):
        block = pos_local
        acc = torch.zeros_like(pos_local)
        for i in range(mesh.ndev):
            acc = acc + _local_direct(pos_local, block, eps2, dim)
            if i + 1 < mesh.ndev:
                block = mesh.ring_shift(block, -1)
        return kappa * acc

    return ring_impl if scheme == "ring" else allgather_impl


def pad_to_multiple(pos: torch.Tensor, multiple: int, far: float = 1e18):
    """Pad rows to a multiple, parking padded particles at `far` so their
    pair weights vanish (as ops.direct does).  Returns (padded, n)."""
    n = pos.shape[0]
    npad = -(-n // multiple) * multiple
    if npad == n:
        return pos, n
    pad = torch.full((npad - n, pos.shape[1]), far, dtype=pos.dtype,
                     device=pos.device)
    return torch.cat([pos, pad]), n
