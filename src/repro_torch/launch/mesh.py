"""Process groups and device meshes over torch.distributed.

JAX drives every device of a Mesh from one process; PyTorch runs one
process per rank. A mesh here is a torch DeviceMesh with named dims
("data", "model"), and every sharded entry point of the port is
collective: each rank calls it with the same arguments.

Backends follow the device, with no downgrade: NCCL for a CUDA mesh, gloo
for a CPU mesh. A mesh whose group runs another backend, or a tensor on
another device type than its mesh, raises. Every group gets a timeout, so
a collective that one rank never joins fails instead of hanging.

The one exception is the dry run's world (`make_dryrun_mesh`): rank 0 of
a production-sized world in one process, over torch's fake backend, whose
collectives move nothing. Only a mesh that make_dryrun_mesh made accepts
that backend (`make_mesh` and `mesh_axis` refuse it on any other).

Ends of worlds. Every world of the port ends through close_world, most
through open_world around the code that uses it: the holders of its
groups are retired first (the pumped AsyncBatchers still running, the
DEFAULT_REGISTRY rows that serve on a mesh, the meshes' own references),
then the default group goes, so no group is left for the interpreter's
shutdown to tear down. After a normal end the group is destroyed. After
an exception the world counts as broken, since another rank may wait in
a collective this one never joins. Its groups are then aborted: NCCL's
communicators are aborted rather than destroyed, and a gloo abort closes
the connections, so the peers fail at once instead of at the timeout.
Under load a gloo rank that went through the interpreter's shutdown
after a broken collective still died by SIGABRT ("terminate called
without an active exception", about 1 exit in 50), so a process whose
world broke does not go through that shutdown at all: run_process
flushes its output and leaves through os._exit, with BROKEN_EXIT when an
exception ended it.

Functions only: importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import sys
import tempfile
import traceback
import weakref
from typing import Iterator, NamedTuple, NoReturn, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# How long a collective waits for every rank before it fails.
TIMEOUT = datetime.timedelta(seconds=300)
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# The dry run's meshes: the only ones whose groups may run the fake
# backend. The dry run's fake tensors carry autograd, which a CPU-only
# torch cannot do for a "cuda" tensor (the process aborts), and which on
# a machine with a card would start the card's autograd threads: so they,
# and the mesh whose device type they must share, are "cpu" everywhere.
DRYRUN_DEVICE = "cpu"
FAKE_BACKEND = "fake"       # registered by torch's fake_pg module
# id -> mesh, held weakly: a DeviceMesh compares equal to any mesh of its
# shape and names, so membership goes by identity.
_DRYRUN_MESHES = weakref.WeakValueDictionary()
# Every other mesh make_mesh made, by id, held weakly: close_world drops
# their references to the groups.
_MESHES = weakref.WeakValueDictionary()
# The code of a process that leaves through run_process after an exception
# ended its world: sysexits' EX_SOFTWARE. Never a signal's.
BROKEN_EXIT = 70
# Whether a world of this process ended broken (close_world(broken=True)).
_ENDED = {"broken": False}


def _device_type(device) -> str:
    """"cuda" when device is None (the port's default; no fallback to the
    CPU), else the type of `device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the card by default and no CUDA device "
                "is available; pass device='cpu' for a gloo mesh")
        return "cuda"
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no mesh backend for device type {kind!r}")
    return kind


def init_world(device=None, timeout: datetime.timedelta = TIMEOUT, *,
               store=None, rank: int = 0, size: int = 1) -> int:
    """The default process group, made when none exists: through `store`
    as rank `rank` of `size` when a store is given, else from the
    launcher's environment (RANK / WORLD_SIZE, as torchrun sets them), or
    else a world of one rank through a FileStore in a temporary file.
    Returns the world size."""
    kind = _device_type(device)
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        backend = BACKENDS[kind]
        if store is not None:
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=size, timeout=timeout)
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, timeout=timeout)
        else:
            fd, path = tempfile.mkstemp(prefix="repro_torch_store_")
            os.close(fd)
            os.unlink(path)
            dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                    rank=0, world_size=1, timeout=timeout)
    return dist.get_world_size()


@contextlib.contextmanager
def open_world(device=None, timeout: datetime.timedelta = TIMEOUT,
               **store) -> Iterator[int]:
    """init_world for the block (`store`: its store, rank and size);
    yields the world size. A world the block made is ended through
    close_world when the block is left: in order after a normal end, as
    broken when an exception leaves it. A world that existed before is
    left to whoever made it, and so is its exception."""
    made = not dist.is_initialized()
    size = init_world(device, timeout, **store)
    try:
        yield size
    except BaseException:
        if made:
            close_world(broken=True)
        raise
    if made:
        close_world()


def close_world(*, broken: bool = False) -> None:
    """End this process's world, holders first: the pumped AsyncBatchers
    still running (stop(), so rank 0 sends each one's STOP; after a broken
    collective abandon(), which sends nothing), the DEFAULT_REGISTRY rows
    that serve on a mesh, and every mesh's references to its groups
    (`_pg_registry`). Then the default group: destroyed, or, broken,
    aborted (every group, NCCL's communicators included; on a torch
    whose gloo cannot abort, destroyed, which is what follows the abort
    in any case). A holder that cannot retire in order makes the end
    broken, and the group ends all the same. Idempotent; a process with
    no group only retires the holders. Whether to end a world that some
    caller made is that caller's choice (open_world ends only its
    own)."""
    try:
        # A module never imported holds no batcher and no row.
        pump = sys.modules.get("repro_torch.serve.pump")
        if pump is not None:
            pump.PUMP.retire(broken)
        registry = sys.modules.get("repro_torch.serve.registry")
        if registry is not None:
            registry.DEFAULT_REGISTRY.unregister_meshed()
    except BaseException:
        broken = True        # a holder that could not retire in order
        raise
    finally:
        for meshes in (_MESHES, _DRYRUN_MESHES):
            for mesh in list(meshes.values()):
                getattr(mesh, "_pg_registry", {}).clear()
            meshes.clear()
        _end_group(broken)


def _end_group(broken: bool) -> None:
    if broken:
        _ENDED["broken"] = True
        abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
        if abort is not None and dist.is_initialized():
            try:
                abort()
            except RuntimeError as exc:      # a backend that cannot abort
                print(f"close_world: abort failed ({exc}); destroying",
                      file=sys.stderr, flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def world_broke() -> bool:
    """True once a world of this process ended broken."""
    return _ENDED["broken"]


def run_process(main, *args) -> NoReturn:
    """Run `main(*args)` as the whole of a process and leave with its
    code (None is 0). When a world of this process ended broken, the
    process prints what ended `main`, flushes its output and leaves
    through os._exit, never through the interpreter's shutdown: with
    BROKEN_EXIT when an exception ended `main`, else with its code. The
    rank whose compute failed and the follower whose collective then
    failed leave alike."""
    try:
        code = main(*args)
    except SystemExit as exc:
        code = exc.code
    except BaseException:
        if not world_broke():
            raise
        traceback.print_exc()
        code = BROKEN_EXIT
    if not world_broke():
        raise SystemExit(code)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code if isinstance(code, int) else int(code is not None))


def make_mesh(shape: Sequence[int], names: Sequence[str], device=None):
    """A DeviceMesh of `shape` over the whole world, dims named `names`;
    the world must hold exactly prod(shape) ranks."""
    kind = _device_type(device)
    world = init_world(kind)
    want = 1
    for s in shape:
        want *= int(s)
    if world != want:
        raise ValueError(f"a {tuple(shape)} mesh needs {want} ranks; the "
                         f"world has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(kind, torch.arange(want).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))
    for name in names:
        _check_backend(mesh, mesh.get_group(name))
    _MESHES[id(mesh)] = mesh
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks per pod ("data", "model"); 2 pods = 512 with a
    leading "pod" dim. Raises when the world is not that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device)


def make_dryrun_mesh(multi_pod: bool = False, *, shape=None):
    """The dry run's world: a process group of the fake backend (no
    communication; every collective returns at once and leaves its output
    as it was) of JAX's production size, (16, 16) ("data", "model") or
    (2, 16, 16) with a leading "pod", this process as its rank 0, and a
    DeviceMesh of type DRYRUN_DEVICE over it. `shape`: a ("data",
    "model") shape in place of the production one (a world of one for a
    measured step). Refuses to start where any process group exists: it
    never reuses one. Tear it down with destroy_dryrun_mesh."""
    if dist.is_initialized():
        raise RuntimeError("a dry-run world starts only where no process "
                           "group exists; this process has one")
    if shape is not None:
        names = ("data", "model")
        shape = tuple(int(s) for s in shape)
        if len(shape) != 2:
            raise ValueError(f"shape {shape}: a (data, model) pair")
    elif multi_pod:
        shape, names = (2, 16, 16), ("pod", "data", "model")
    else:
        shape, names = (16, 16), ("data", "model")
    # Importing the module registers the backend (once per process).
    from torch.testing._internal.distributed import fake_pg
    world = math.prod(shape)
    dist.init_process_group(FAKE_BACKEND, store=fake_pg.FakeStore(),
                            rank=0, world_size=world)
    try:
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh(DRYRUN_DEVICE, torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
    except BaseException:
        close_world()
        raise
    _DRYRUN_MESHES[id(mesh)] = mesh
    return mesh


def destroy_dryrun_mesh(mesh) -> None:
    """Tear down the world make_dryrun_mesh made through close_world:
    every process group of this process goes."""
    if not _is_dryrun(mesh):
        raise ValueError("not a mesh of make_dryrun_mesh")
    close_world()


def _is_dryrun(mesh) -> bool:
    return _DRYRUN_MESHES.get(id(mesh)) is mesh


def make_debug_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over the world (tests, one card, torchrun);
    makes a world of one rank when no process group exists."""
    return make_mesh((data, model), ("data", "model"), device)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Batch axes: ("pod", "data") when present, else ("data",)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.mesh_dim_names else None


def _check_backend(mesh, group) -> None:
    want = BACKENDS.get(mesh.device_type)
    have = str(dist.get_backend(group))
    if have == FAKE_BACKEND and _is_dryrun(mesh):
        return
    if want is None or want not in have:
        raise ValueError(f"a {mesh.device_type} mesh needs the {want} "
                         f"backend; its group runs {have}")


class MeshAxis(NamedTuple):
    """One dim of a mesh as a collective sees it: its process group, its
    size, this rank's coordinate along it, and the mesh's device type."""
    group: object
    size: int
    index: int
    device_type: str

    def check(self, what: str, *tensors: torch.Tensor) -> None:
        """Raise unless every tensor lies on the mesh's device type."""
        for t in tensors:
            if t.device.type != self.device_type:
                raise ValueError(f"{what}: a tensor on {t.device} for a "
                                 f"{self.device_type} mesh")

    def peer(self, index: int) -> int:
        """The global rank at `index` along this dim."""
        return dist.get_global_rank(self.group, index)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the dim, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_many(self, *ts: torch.Tensor) -> list:
        """Sum several tensors over the dim in one collective (one message
        of their flattened concatenation); returns them, reduced, in their
        shapes."""
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]))
        out, at = [], 0
        for t in ts:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return out

    def all_gather_cat(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `t` (same shape on each), concatenated along `dim`
        in the order of the dim."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)


def mesh_axis(mesh, axis: str = "data") -> MeshAxis:
    """The dim `axis` of `mesh`, its backend checked against the mesh's
    device type."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; have {names}")
    group = mesh.get_group(axis)
    _check_backend(mesh, group)
    return MeshAxis(group=group, size=int(mesh.size(names.index(axis))),
                    index=int(mesh.get_local_rank(axis)),
                    device_type=mesh.device_type)
