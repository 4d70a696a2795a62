"""Meshes of ranks over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  The reference is single-controller:
one program runs ``shard_map`` over a ``jax.sharding.Mesh`` of devices.  The
port is multi-controller: every rank is a process that holds only its own
shards, and ``Mesh`` is this rank's view of the grid of ranks:

  * ``shape`` and ``axis_names`` as in the reference (("data", "model"));
    ranks are laid out row-major over the shape, so ``coords`` (this rank's
    place along each axis) is ``numpy.unravel_index(rank, shape)``;
  * one process group per line along every set of axes: every rank creates
    every group, in the same order, and keeps the one it lies on.  A
    collective over ("model",) on a (2, 2) mesh therefore runs on this
    rank's row, never on the world;
  * ``all_reduce``/``all_gather`` over a set of axes, the collectives the
    shard bodies call (``api.spmd.ShardContext``), ``reduce_scatter``, the
    backward of FSDP's gather (NCCL's ``reduce_scatter_tensor``; gloo has
    none, so there it is an ``all_reduce`` and this rank's block of the
    sum, ``reduce_scatter_transport``), and ``ppermute``, the
    asynchronous point-to-point shift of the halo bodies: it returns a
    ``Transfer`` at once, and the rank sweeps its interior before it calls
    ``wait()`` for what its neighbour sent.

The backend is NCCL when each rank has a card of its own and gloo when the
ranks outnumber the cards (two ranks on one card: NCCL refuses a second
rank on a device).  Gloo's collectives on CUDA tensors go through a pinned
host buffer that this module stages explicitly (``transport`` "gloo via
pinned host buffers"), so what crosses the wire, and how, is stated, not
left to a silent fallback.  Kernels always run on the rank's device.
``comm`` counts the collectives and shifts a rank ran, their bytes and
their seconds on the host's clock, staging included.

A shift in flight holds pinned buffers of its own, one to send and one to
receive: two halos go out before either is waited on, so the one staging
buffer a dtype of the collectives would be overwritten.  Its device-to-host
copy runs on a side stream behind an event recorded when it is issued, so
it waits for the work that wrote the rows it sends and never for a kernel
launched after it.  Each shift takes the next tag of a counter every rank
advances in the same order, so the two shifts of a two-rank ring, which
have the same peer both ways, never take each other's message.

``spawn`` starts one process a rank with ``torch.multiprocessing``'s
``spawn`` start method and returns each rank's result.  It lives in the
package, so a child unpickles its target from here and never imports a test
module (or JAX through one).

The reference's ``make_production_mesh`` (a 256- or 512-chip TPU pod) has no
counterpart on one card (ROADMAP A11).
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.kernels.util import trace

# seconds a collective may wait for its peers before the rank fails
TIMEOUT_S = 600

_OPS = {"sum": "SUM", "max": "MAX"}

# shift tags cycle below this bound (gloo takes any non-negative int)
_TAGS = 1 << 24


class Transfer:
    """A ``Mesh.ppermute`` in flight.  ``wait()`` completes it and returns
    what this rank received, on the rank's device (zeros of the sent
    tensor's shape where no pair of the permutation sends to this rank)."""

    def __init__(self, mesh, x, send_to, recv_from, tag, t0):
        import torch.distributed as dist

        self.mesh, self.tag = mesh, tag
        self.shape, self.dtype = tuple(x.shape), x.dtype
        self.recv_from, self.send_to = recv_from, send_to
        self.seconds = 0.0
        self.result = None
        staged = mesh.staged
        if staged:
            # the copy waits for what was enqueued before this call only
            issued = torch.cuda.Event()
            issued.record()
            stream = mesh._side_stream()
            with torch.cuda.stream(stream):
                stream.wait_event(issued)
                self.send = (torch.empty(self.shape, dtype=x.dtype,
                                         pin_memory=True)
                             if send_to is not None else None)
                if self.send is not None:
                    self.send.copy_(x, non_blocking=True)
                    x.record_stream(stream)
                self.copied = torch.cuda.Event()
                self.copied.record(stream)
        else:
            self.send = (x.detach().clone(memory_format=torch.contiguous_format)
                         if send_to is not None else None)
        self.recv = None
        if recv_from is not None:
            self.recv = (torch.empty(self.shape, dtype=x.dtype,
                                     pin_memory=True) if staged
                         else torch.empty(self.shape, dtype=x.dtype,
                                          device=x.device))
        self.works = None if staged else self._post(dist)
        self.seconds += time.perf_counter() - t0

    def _post(self, dist) -> list:
        ops = []
        if self.send_to is not None:
            ops.append(dist.P2POp(dist.isend, self.send, self.send_to,
                                  tag=self.tag))
        if self.recv_from is not None:
            ops.append(dist.P2POp(dist.irecv, self.recv, self.recv_from,
                                  tag=self.tag))
        return dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> torch.Tensor:
        if self.result is not None:
            return self.result
        import torch.distributed as dist

        t0 = time.perf_counter()
        if self.works is None:        # staged: post once the copy is done
            self.copied.synchronize()
            self.works = self._post(dist)
        for w in self.works:
            w.wait()
        dev = self.mesh.device
        if self.recv is None:
            out = torch.zeros(self.shape, dtype=self.dtype, device=dev)
        else:
            out = self.recv.to(dev, non_blocking=True)
        self.seconds += time.perf_counter() - t0
        self.mesh.comm["seconds"] += self.seconds
        trace("wait", tag=self.tag)
        self.result = out
        return out


class Arrived:
    """A result already on this rank, waited on like a ``Transfer``."""

    def __init__(self, x: torch.Tensor):
        self.result = x

    def wait(self) -> torch.Tensor:
        return self.result


class Mesh:
    """This rank's view of a (data, model, ...) grid of ranks.

    Needs ``torch.distributed`` initialised with a world of
    ``prod(shape)`` ranks (``spawn`` does that), or none at all for a
    one-rank mesh.  ``device`` is where this rank's tensors live."""

    def __init__(self, shape, axis_names=("data", "model"), *,
                 device="cpu"):
        import torch.distributed as dist

        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} vs axes "
                             f"{self.axis_names}")
        self.size = math.prod(self.shape)
        self.device = torch.device(device)
        initialised = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if initialised else 1
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"the process group has {world}")
        self.rank = dist.get_rank() if initialised else 0
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                            self.shape))
        self.backend = dist.get_backend() if initialised else "none"
        # gloo reduces host memory: a rank on a card stages through pinned
        # buffers, one a dtype, grown as needed
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.transport = ("gloo via pinned host buffers" if self.staged
                          else self.backend)
        self.reduce_scatter_transport = (
            "reduce_scatter_tensor" if self.backend == "nccl"
            else "all_reduce, then this rank's block")
        self._pinned: dict[torch.dtype, torch.Tensor] = {}
        self._stream = None
        self._shifts = 0
        self.comm = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self._groups: dict[tuple[str, ...], object] = {}
        if self.size > 1:
            # every subset of axes, every line along it, the same order on
            # every rank: new_group is itself a collective over the world
            for k in range(1, len(self.axis_names) + 1):
                for sub in itertools.combinations(range(len(self.shape)), k):
                    others = [i for i in range(len(self.shape))
                              if i not in sub]
                    for fixed in itertools.product(
                            *(range(self.shape[i]) for i in others)):
                        ranks = []
                        for moving in itertools.product(
                                *(range(self.shape[i]) for i in sub)):
                            coord = [0] * len(self.shape)
                            for i, c in zip(others, fixed):
                                coord[i] = c
                            for i, c in zip(sub, moving):
                                coord[i] = c
                            ranks.append(int(np.ravel_multi_index(
                                coord, self.shape)))
                        group = dist.new_group(sorted(ranks))
                        if self.rank in ranks:
                            key = tuple(self.axis_names[i] for i in sub)
                            self._groups[key] = group

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.axis_sizes)}, rank {self.rank} at "
                f"{self.coords}, {self.transport}, {self.device})")

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def _canon(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"mesh axes {unknown} not in {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        """Ranks along ``axes`` (1 for none)."""
        return math.prod(self.axis_sizes[a] for a in self._canon(axes))

    def index(self, axes) -> int:
        """This rank's linear index along ``axes``, row-major over the axis
        tuple as given (0 for none)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def group(self, axes):
        """The process group of this rank's line along ``axes``."""
        return self._groups[self._canon(axes)]

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` copied into this rank's pinned host buffer of its dtype
        (a view of it, valid until the next staging)."""
        buf = self._pinned.get(x.dtype)
        if buf is None or buf.numel() < x.numel():
            buf = torch.empty(x.numel(), dtype=x.dtype, pin_memory=True)
            self._pinned[x.dtype] = buf
        out = buf[:x.numel()].view(x.shape)
        out.copy_(x)
        return out

    def _side_stream(self):
        """The side stream a staged shift copies its rows to the host on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _count(self, x: torch.Tensor, primitive: str, axes,
               t0: float | None = None, tag: int | None = None) -> None:
        """Count one call on ``x`` in ``comm`` and trace its issue: a
        shift's by its ``tag`` (its ``Transfer`` adds the seconds and traces
        the wait), a blocking collective's with its wait and its seconds
        since ``t0``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        nbytes = x.numel() * x.element_size()
        self.comm["calls"] += 1
        self.comm["bytes"] += nbytes
        trace("issue", tag=tag, primitive=primitive, axes=axes,
              nbytes=nbytes)
        if tag is None:
            self.comm["seconds"] += time.perf_counter() - t0
            trace("wait", tag=None)

    def ppermute(self, x: torch.Tensor, axes, perm) -> Transfer:
        """Start shifting ``x`` between the ranks along ``axes``: ``perm``
        holds ``(source, destination)`` pairs of their index along ``axes``
        (``index(axes)``), as ``jax.lax.ppermute`` takes them.  Returns at
        once; the ``Transfer``'s ``wait()`` gives what this rank received.
        Every rank calls it, in the same order, with the same ``perm``.
        Counted in ``comm`` as one call of ``x``'s bytes, the payload the
        planner prices (``core.planner.COMM_MODEL``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        perm = [(int(s), int(d)) for s, d in perm]
        n = self.axis_size(axes) if axes else 1
        srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or not all(0 <= i < n for i in srcs + dsts)):
            raise ValueError(f"ppermute {perm} is not a permutation of "
                             f"{n} ranks along {axes}")
        t0 = time.perf_counter()
        tag = self._shifts % _TAGS
        self._shifts += 1
        me = self.index(axes)
        line = self._line_ranks(axes)
        send_to = next((line[d] for s, d in perm if s == me), None)
        recv_from = next((line[s] for s, d in perm if d == me), None)
        self._count(x, "ppermute", axes, tag=tag)
        return Transfer(self, x, send_to, recv_from, tag, t0)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """A new tensor: ``x`` reduced over the ranks along ``axes`` by
        ``op`` ("sum", "max" or "mean"), the same bits on every one of
        them.  ``x`` is left as it was."""
        n = self.axis_size(axes) if axes else 1
        if n <= 1:
            return x.clone()
        import torch.distributed as dist

        t0 = time.perf_counter()
        red = getattr(dist.ReduceOp, _OPS["sum" if op == "mean" else op])
        buf = (self._stage(x) if self.staged
               else x.clone(memory_format=torch.contiguous_format))
        dist.all_reduce(buf, op=red, group=self.group(axes))
        if op == "mean":
            buf.div_(n)
        out = buf.to(x.device, copy=True) if self.staged else buf
        self._count(x, "all_reduce", axes, t0)
        return out

    def all_gather(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The ranks' ``x`` along ``axes`` concatenated along ``dim`` in the
        order of their index (``index(axes)``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = self.axis_size(axes) if axes else 1
        if n <= 1:
            return x
        import torch.distributed as dist

        t0 = time.perf_counter()
        src = self._stage(x) if self.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.group(axes))
        # the group's rank order is the global rank order; put the parts in
        # the order of the index along ``axes`` as given
        ranks = sorted(self._line_ranks(axes))
        order = [self._index_of(r, axes) for r in ranks]
        out = torch.cat([parts[order.index(i)] for i in range(n)], dim=dim)
        out = out.to(x.device) if self.staged else out
        self._count(x, "all_gather", axes, t0)
        return out

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int
                       ) -> torch.Tensor:
        """This rank's block (``index(axes)``, of ``x.shape[dim] / n``
        along ``dim``) of ``x`` summed over the ranks along ``axes``: the
        backward of ``all_gather``.  NCCL reduces and scatters in one call;
        gloo has no reduce-scatter, so it sums the whole of ``x`` and keeps
        this rank's block.  Counted in ``comm`` as one call of ``x``'s
        bytes, which both send."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = self.axis_size(axes) if axes else 1
        if n <= 1:
            return x.clone()
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over the {n} ranks of {axes}")
        import torch.distributed as dist

        t0 = time.perf_counter()
        step = x.shape[dim] // n
        me = self.index(axes)
        if self.backend == "nccl":
            src = x.movedim(dim, 0).contiguous()
            out = torch.empty((step, *src.shape[1:]), dtype=x.dtype,
                              device=x.device)
            # the group's rank order is the global one: put this rank's
            # block where its place in the group takes it
            ranks = sorted(self._line_ranks(axes))
            order = [self._index_of(r, axes) for r in ranks]
            src = torch.cat([src[i * step:(i + 1) * step] for i in order])
            dist.reduce_scatter_tensor(out, src, group=self.group(axes))
            out = out.movedim(0, dim).contiguous()
        else:
            buf = (self._stage(x) if self.staged
                   else x.clone(memory_format=torch.contiguous_format))
            dist.all_reduce(buf, group=self.group(axes))
            mine = buf.narrow(dim, me * step, step)
            out = torch.empty(mine.shape, dtype=x.dtype,
                              device=x.device).copy_(mine)
        self._count(x, "reduce_scatter", axes, t0)
        return out

    def _line_ranks(self, axes) -> list[int]:
        sub = [self.axis_names.index(a) for a in axes]
        ranks = []
        for moving in itertools.product(*(range(self.shape[i]) for i in sub)):
            coord = list(self.coords)
            for i, c in zip(sub, moving):
                coord[i] = c
            ranks.append(int(np.ravel_multi_index(coord, self.shape)))
        return ranks

    def _index_of(self, rank: int, axes) -> int:
        coords = np.unravel_index(rank, self.shape)
        idx = 0
        for a in axes:
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + int(coords[i])
        return idx


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *, device="cpu"):
    """A mesh over the ranks ``torch.distributed`` has (one process: a
    one-rank mesh, which routes nothing through the SPMD path)."""
    return Mesh(shape, axes, device=device)


def mesh_axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.shape)).get(name, 1)


def parse_shape(text: str) -> tuple[int, int]:
    """``"DxM"`` (e.g. ``"1x2"``) as (data, model)."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {text!r} is not DxM, e.g. 1x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"mesh {text!r} needs positive axes")
    return d, m


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(rank, world, shape, axes, device, backend, fn, args, out_dir):
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        index = rank if world <= torch.cuda.device_count() else 0
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    else:
        # ranks on the CPU share its cores: one thread each
        torch.set_num_threads(1)
    # a file store in the spawn's own directory: no port to race for
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(out_dir, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = Mesh(shape, axes, device=dev)
        result = fn(mesh, *args)
        torch.save(_to_cpu(result), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def default_backend(n_ranks: int, device) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def spawn(fn, shape, axes=("data", "model"), *, device="cuda", backend=None,
          args=()) -> list:
    """Run ``fn(mesh, *args)`` on ``prod(shape)`` new processes, one a rank
    of a mesh of ``shape`` over ``axes``, and return each rank's result in
    rank order (tensors moved to the CPU).  ``fn`` must be importable by
    module and name.  On ``device="cuda"`` rank r uses card r, or card 0
    for every rank when the ranks outnumber the cards; a CPU rank runs one
    thread.  A rank that raises fails the call (the others
    are stopped)."""
    world = math.prod(int(s) for s in shape)
    backend = backend or default_backend(world, device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as out_dir:
        torch.multiprocessing.start_processes(
            _rank_main,
            args=(world, tuple(shape), tuple(axes), str(device), backend,
                  fn, tuple(args), out_dir),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
