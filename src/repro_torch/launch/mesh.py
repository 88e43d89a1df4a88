"""Starting the party group: the port's counterpart of
``repro.launch.mesh``'s party mesh (``make_party_mesh``).

``make_party_group(n)`` takes the group the launcher started: torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), or ``spawn_ranks``, which starts the ranks as processes
over a FileStore. It returns a ``core.party_group.PartyGroup``, which
holds the collectives the engines use. The backend and each rank's
device follow one rule (``party_backend``), printed by rank 0 when it
starts the group:

  * CPU tensors: gloo;
  * the card, with at least as many GPUs as ranks: NCCL, one card a rank;
  * the card, with fewer GPUs than ranks: gloo, every rank on cuda:0
    (NCCL refuses two ranks on one device); gloo stages each collective
    through the host.

``launcher_group`` and ``quiet_other_ranks`` are the launchers' shared
handling of ``--engine sharded --party-devices N``.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import sys
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.party_group import PartyGroup
from repro_torch.device import resolve_device

# a collective that waits longer than this raises instead of hanging
TIMEOUT_S = 300


def party_backend(world: int, device=None):
    """(backend, device of rank ``local_rank``) by the module's rule, for a
    group of ``world`` ranks on ``device`` (None = the card)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return "gloo", device
    if torch.cuda.device_count() >= world:
        return "nccl", None          # cuda:LOCAL_RANK, set by the rank
    return "gloo", torch.device("cuda", 0)


def _rank_device(backend: str, device) -> torch.device:
    _, dev = party_backend(dist.get_world_size(), device)
    if backend == "nccl":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev


def init_group(world: int, rank: int, device=None,
               init_method: str = "env://") -> str:
    """Start the default ``torch.distributed`` group by ``party_backend``'s
    rule; rank 0 prints the choice. Returns the backend."""
    backend, _ = party_backend(world, device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if rank == 0:
        print(f"party group: {world} ranks, backend {backend} "
              f"({torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" GPUs visible, device {resolve_device(device)})", flush=True)
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
    backend = dist.get_backend()
    pg = None
    if n < world:
        pg = dist.new_group(list(range(n)),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if rank >= n:
        return None
    return PartyGroup(rank=rank, size=n, pg=pg,
                      device=_rank_device(backend, device), backend=backend)


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


def _rank_main(fn, rank, n, init_method, device, threads, args, conn):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank))
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
    raises fails the call with its traceback; one that does not answer
    within ``timeout_s`` fails it too. ``threads`` > 0 sets each rank's
    torch threads."""
    ctx = mp.get_context("spawn")
    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, "party_group_store")
    if os.path.exists(store):
        os.remove(store)
    init_method = "file://" + store
    conns, procs = [], []
    for r in range(n):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, daemon=True,
                        args=(fn, r, n, init_method, device, threads, args,
                              send))
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    try:
        out = []
        for r, c in enumerate(conns):
            if not c.poll(timeout_s):
                raise TimeoutError(f"rank {r} sent nothing in {timeout_s} s")
            kind, val = c.recv()
            if kind == "error":
                raise RuntimeError(f"rank {r} of {n} failed:\n{val}")
            out.append(val)
        return out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
