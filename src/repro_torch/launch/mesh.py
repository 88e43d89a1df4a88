"""Starting the party group and the FSDP plan's mesh: the port's
counterpart of ``repro.launch.mesh`` (``make_party_mesh``,
``make_debug_mesh``, ``make_production_mesh``, ``abstract_mesh``).

``make_party_group(n)`` takes the group the launcher started: torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or ``spawn_ranks``, which starts the ranks as processes
over a FileStore. It returns a ``core.party_group.PartyGroup``, which
holds the collectives the engines use. The backend and each rank's
device follow one rule (``party_backend``), printed by rank 0 when it
starts the group:

  * CPU tensors: gloo;
  * the card, with at least as many GPUs as ranks: NCCL, one card a rank
    (``cuda:LOCAL_RANK``, bound by ``torch.cuda.set_device`` before the
    group starts). The group is ``"cpu:gloo,cuda:nccl"``: NCCL carries
    every CUDA tensor, gloo the host operands (``gather_object``'s
    pickles, a host tensor handed to a collective), which an NCCL-only
    group refuses;
  * the card, with fewer GPUs than ranks: gloo, every rank on cuda:0
    (NCCL refuses two ranks on one device); gloo stages each collective
    through the host.

Every group is warmed by one collective when it is made (``warm``): an
NCCL communicator is built at its group's first collective, which would
otherwise land in whatever is timed first.

``launcher_group`` and ``quiet_other_ranks`` are the launchers' shared
handling of ``--engine sharded --party-devices N``.

The FSDP plan (``repro_torch.sharding``) runs over a ``MeshGroup``: the
world's ranks laid out row-major over named axes (``("data", "model")``,
as ``jax.make_mesh`` lays out host devices), with one ``torch.distributed``
sub-group for every tuple of axes, each made by every rank in the same
order (a rank that skipped a group it is not in would leave the others
waiting). Every byte the plan moves goes through its ``all_gather``,
``reduce_scatter``, ``all_reduce`` and ``broadcast``, so a test can wrap
them (``RecordingMesh``, which also stands in for the group on the meta
device). ``make_debug_mesh`` starts a live one; ``make_production_mesh``
and ``abstract_mesh`` return device-free ``AbstractMesh``es, whose rank 0
the rules and the dry run see: the port cannot start the reference's 256
or 512 ranks.
"""
from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing as mp
import os
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.party_group import PartyGroup
from repro_torch.device import resolve_device

# a collective that waits longer than this raises instead of hanging
TIMEOUT_S = 300


def party_backend(world: int, device=None):
    """(backend, this rank's device) by the module's rule, for a group of
    ``world`` ranks on ``device`` (None = the card): the NCCL rank's card
    is ``cuda:LOCAL_RANK``. Reads the device count only: no CUDA context
    is made before the rank binds its card."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind != "cuda":
        return "gloo", torch.device(device)
    if not torch.cuda.is_available():
        resolve_device(None)                  # raises: no card
    if torch.cuda.device_count() >= world:
        return "nccl", torch.device("cuda",
                                    int(os.environ.get("LOCAL_RANK", 0)))
    return "gloo", torch.device("cuda", 0)


# the group an NCCL rank starts: NCCL for CUDA tensors, gloo for host ones
NCCL_GROUP = "cpu:gloo,cuda:nccl"


def _backend_name() -> str:
    """The running group's backend by the module's rule: "nccl" for the
    NCCL group (whose host operands go over gloo), else gloo's name."""
    b = str(dist.get_backend())
    return "nccl" if "nccl" in b else b


def _rank_device(backend: str, device) -> torch.device:
    backend_, dev = party_backend(dist.get_world_size(), device)
    if backend != backend_:
        raise RuntimeError(f"the group runs {backend}, the rule gives "
                           f"{backend_} for {device}")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    return dev


def init_group(world: int, rank: int, device=None,
               init_method: str = "env://") -> str:
    """Start the default ``torch.distributed`` group by ``party_backend``'s
    rule (an NCCL rank binds its card first); rank 0 prints the choice.
    Returns the backend."""
    backend, dev = party_backend(world, device)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(NCCL_GROUP if backend == "nccl" else backend,
                            init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if rank == 0:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        where = ("cuda:LOCAL_RANK, one card a rank" if backend == "nccl"
                 else dev)
        print(f"party group: {world} ranks, backend {backend} ({n} GPUs "
              f"visible, device {where})", flush=True)
    return backend


def make_party_group(n: int | None = None, *,
                     device=None) -> Optional[PartyGroup]:
    """The party group over ranks 0..n-1 (None = every rank).

    Joins the group the launcher started; under torchrun, whose processes
    start none, starts it from the environment. Every rank of the world
    must call this (a subgroup is made collectively); a rank outside the
    first ``n`` gets None."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no party group: start one process per rank with torchrun "
                "(or mesh.spawn_ranks), or pass the group")
        init_group(int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                   device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n or world
    if n > world:
        raise ValueError(f"a party group of {n} ranks in a world of "
                         f"{world}")
    backend = _backend_name()
    pg = None
    if n < world:
        pg = dist.new_group(list(range(n)),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if rank >= n:
        return None
    group = PartyGroup(rank=rank, size=n, pg=pg,
                       device=_rank_device(backend, device), backend=backend)
    group.warm()
    return group


# ---------------------------------------------------------------------------
# the FSDP plan's meshes
# ---------------------------------------------------------------------------


class AbstractMesh:
    """Named axes and their sizes (``axis_names``, ``shape``: name ->
    size), and one rank's coordinates on them (rank 0's by default): what
    the sharding rules read, with no group behind it."""

    def __init__(self, shape, names, rank: int = 0):
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.coords = self._coords(rank)
        self.device = torch.device("meta")

    def _coords(self, rank: int) -> Dict[str, int]:
        out = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return out

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or names) in mesh order; a tuple out of mesh
        order has no group (its block order would not be the ranks')."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} out of mesh order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def coord(self, axes) -> int:
        """This rank's index over ``axes`` (row-major, the first slowest):
        its block of a dim that lies over them."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def _collective(self, *_):
        raise RuntimeError("an abstract mesh moves no data: wrap it in "
                           "RecordingMesh")

    all_gather = reduce_scatter = all_reduce = broadcast = _collective


class MeshGroup(AbstractMesh):
    """A live mesh over the world's ranks: this rank's coordinates, its
    device and backend, and one sub-group per tuple of axes. Every
    collective of the FSDP plan is one of the four methods below, each
    over the sub-group of ``axes`` holding this rank, in block order.
    Under gloo a CUDA tensor crosses through ordinary host memory
    (``_staged``): gloo's own staging keeps its pinned buffers in the
    caching host allocator, which at a model's width grows by gigabytes a
    rank."""

    def __init__(self, shape, names, device, backend: str):
        super().__init__(shape, names, dist.get_rank())
        if self.size != dist.get_world_size():
            raise ValueError(f"a {self.shape} mesh over "
                             f"{dist.get_world_size()} ranks")
        self.device, self.backend = device, backend
        self.groups: Dict[Tuple[str, ...], Any] = {}
        names = self.axis_names
        # every tuple of axes, each group made by every rank in one order
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if n == len(names):
                    self.groups[axes] = None          # the world
                    continue
                rest = [a for a in names if a not in axes]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    coords = dict(zip(rest, fixed))
                    ranks = sorted(self._rank_of({**coords, **dict(
                        zip(axes, idx))}) for idx in itertools.product(
                        *(range(self.shape[a]) for a in axes)))
                    g = dist.new_group(
                        ranks, timeout=datetime.timedelta(seconds=TIMEOUT_S))
                    if self.rank in ranks:
                        self.groups[axes] = g
        self.warm()

    def warm(self) -> None:
        """One small all-reduce over every group of this rank, in the
        order every rank made them (so no two ranks wait on each other
        crosswise): each NCCL communicator is built here, not inside the
        first timed collective."""
        x = torch.zeros(1, device=self.device)
        for axes in self.groups:
            self.all_reduce(x, axes)

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.is_cuda

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Every block of ``x`` over ``axes``, concatenated along ``dim``."""
        axes = self.axes(axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        if self._staged(x):
            return self.all_gather(x.cpu(), axes, dim).to(x.device)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.groups[axes])
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, axes,
                       dim: int = 0) -> torch.Tensor:
        """``x`` summed over ``axes``; this rank's block along ``dim``."""
        axes = self.axes(axes)
        n = self.axis_size(axes)
        if n == 1:
            return x
        if self._staged(x):
            return self.reduce_scatter(x.cpu(), axes, dim).to(x.device)
        ins = [c.contiguous() for c in x.chunk(n, dim)]
        out = torch.empty_like(ins[0])
        dist.reduce_scatter(out, ins, group=self.groups[axes])
        return out

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """``x`` reduced ("sum" or "max") over ``axes``, as a new tensor."""
        axes = self.axes(axes)
        if self.axis_size(axes) == 1:
            return x
        if self._staged(x):
            return self.all_reduce(x.cpu(), axes, op).to(x.device)
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        y = x.contiguous().clone()
        dist.all_reduce(y, op=ops[op], group=self.groups[axes])
        return y

    def broadcast(self, x: torch.Tensor, axes, src: int) -> torch.Tensor:
        """The ``x`` of the rank at index ``src`` over ``axes``, in place."""
        axes = self.axes(axes)
        if self.axis_size(axes) == 1:
            return x
        if self._staged(x):
            return x.copy_(self.broadcast(x.cpu(), axes, src))
        coords = dict(self.coords)
        for a in reversed(axes):
            src, coords[a] = divmod(src, self.shape[a])
        dist.broadcast(x, self._rank_of(coords), group=self.groups[axes])
        return x


class RecordingMesh:
    """A mesh whose collectives are recorded: bytes by kind, with the
    reference's HLO convention (``launch/dryrun.py``): an all-gather its
    gathered output, a reduce-scatter its output block, an all-reduce and
    a broadcast their operand; ``count`` collectives. Over a live
    ``MeshGroup`` each call runs; over an abstract mesh it returns an
    empty tensor of the result's shape (meta tensors in the dry run)."""

    KINDS = ("all-gather", "reduce-scatter", "all-reduce", "broadcast")

    def __init__(self, mesh):
        self.inner = mesh
        self.bytes = {k: 0 for k in self.KINDS}
        self.count = 0
        self.calls: List[Tuple[str, Tuple[str, ...], Tuple[int, ...]]] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _record(self, kind, axes, shape, dtype):
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        self.bytes[kind] += n
        self.count += 1
        self.calls.append((kind, tuple(axes), tuple(shape)))

    def _live(self):
        return isinstance(self.inner, MeshGroup)

    def all_gather(self, x, axes, dim=0):
        axes = self.inner.axes(axes)
        n = self.inner.axis_size(axes)
        if n == 1:
            return x
        shape = list(x.shape)
        shape[dim] *= n
        self._record("all-gather", axes, shape, x.dtype)
        if self._live():
            return self.inner.all_gather(x, axes, dim)
        return x.new_empty(shape)

    def reduce_scatter(self, x, axes, dim=0):
        axes = self.inner.axes(axes)
        n = self.inner.axis_size(axes)
        if n == 1:
            return x
        shape = list(x.shape)
        shape[dim] //= n
        self._record("reduce-scatter", axes, shape, x.dtype)
        if self._live():
            return self.inner.reduce_scatter(x, axes, dim)
        return x.new_empty(shape)

    def all_reduce(self, x, axes, op="sum"):
        axes = self.inner.axes(axes)
        if self.inner.axis_size(axes) == 1:
            return x
        self._record("all-reduce", axes, x.shape, x.dtype)
        if self._live():
            return self.inner.all_reduce(x, axes, op)
        return x.clone()

    def broadcast(self, x, axes, src):
        axes = self.inner.axes(axes)
        if self.inner.axis_size(axes) == 1:
            return x
        self._record("broadcast", axes, x.shape, x.dtype)
        if self._live():
            return self.inner.broadcast(x, axes, src)
        return x


def make_debug_mesh(data: int = 2, model: int = 2, *,
                    device=None) -> MeshGroup:
    """A live ``(data, model)`` mesh over the world's ranks (data x model of
    them), for CPU integration tests and one host's card: joins the group
    the launcher started (torchrun's environment, or ``spawn_ranks``), by
    ``party_backend``'s rule."""
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "no group: start one process per rank with torchrun (or "
                "mesh.spawn_ranks)")
        init_group(int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                   device)
    backend = _backend_name()
    return MeshGroup((data, model), ("data", "model"),
                     _rank_device(backend, device), backend)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh, device-free: 16 x 16 ("data",
    "model"), or 2 x 16 x 16 with "pod"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def abstract_mesh(shape, names) -> AbstractMesh:
    """A device-free mesh for sharding-spec logic (rank 0's view)."""
    return AbstractMesh(shape, names)


# ---------------------------------------------------------------------------
# the launchers' --engine sharded --party-devices N
# ---------------------------------------------------------------------------


def launcher_group(args):
    """(party group, this rank's device) for a launcher's ``--engine
    sharded`` (``make_party_group`` over ``--party-devices`` ranks), else
    (None, the device). ``--party-devices`` needs the sharded engine."""
    if args.engine != "sharded":
        if args.party_devices:
            raise ValueError("--party-devices needs --engine sharded")
        return None, resolve_device(args.device)
    group = make_party_group(args.party_devices or None, device=args.device)
    return group, None if group is None else group.device


def quiet_other_ranks(group: Optional[PartyGroup]) -> None:
    """Ranks other than 0 of ``group`` print nothing."""
    if group is not None and group.rank:
        sys.stdout = open(os.devnull, "w")


# ---------------------------------------------------------------------------
# starting ranks as processes (tests, and one host with one card)
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, n, init_method, device, threads, args_conn, conn):
    args = args_conn.recv()
    args_conn.close()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank))
    # the ranks share one host: NCCL's bootstrap over the loopback device
    # (its default skips it, and the host may have no other)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    try:
        init_group(n, rank, device, init_method)
        conn.send(("ok", fn(*args)))
    except BaseException:                     # noqa: BLE001 - sent back
        conn.send(("error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def spawn_ranks(fn: Callable, n: int, *args, store_dir: str, device=None,
                threads: int = 0, timeout_s: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` spawned ranks of a new group (a FileStore
    in ``store_dir``, backend and devices by ``party_backend``) and return
    each rank's result, in rank order. ``fn`` must be importable by the
    children; inside it ``make_party_group`` joins the group. A rank that
    raises fails the call, with every failed rank's traceback (the first
    failure often shows on the others as a closed connection); one that
    does not answer within ``timeout_s``, or dies without answering,
    fails it too. ``threads`` > 0 sets each rank's torch threads."""
    ctx = mp.get_context("spawn")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, "party_group_store")
    if os.path.exists(store):
        os.remove(store)
    init_method = "file://" + store
    conns, procs, arg_conns = [], [], []
    for r in range(n):
        recv, send = ctx.Pipe(duplex=False)
        arg_recv, arg_send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, daemon=True,
                        args=(fn, r, n, init_method, device, threads,
                              arg_recv, send))
        p.start()
        send.close()
        arg_recv.close()
        procs.append(p)
        conns.append(recv)
        arg_conns.append(arg_send)
    # the arguments go once every rank has started: a start blocks until
    # its child has read what it was handed, and a child reads past its
    # target only after importing torch, so arguments larger than a pipe's
    # buffer handed to start() would start the ranks one after another
    for c in arg_conns:
        c.send(args)
        c.close()
    try:
        out, failed = [], []
        for r, c in enumerate(conns):
            if not c.poll(timeout_s):
                failed.append(f"rank {r} sent nothing in {timeout_s} s")
                break
            try:
                kind, val = c.recv()
            except EOFError:
                procs[r].join(timeout=30)
                kind, val = "error", (f"exited without a result (exit code "
                                      f"{procs[r].exitcode})")
            if kind == "error":
                failed.append(f"rank {r} of {n} failed:\n{val}")
            out.append(val)
        if failed:
            raise RuntimeError("\n".join(failed))
        return out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
