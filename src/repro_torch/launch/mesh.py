"""Meshes over ``torch.distributed`` worlds, and a launcher of ranks.

The port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
current world, each rank one process that runs the whole program (JAX
runs one program over every device).  ``make_digit_mesh`` builds the
``("data", "model")`` mesh of digit sharding (``distributed/
sharding.py``); without a process group it starts a world of 1, so a
program runs on a mesh alike with one rank or many, as JAX's 1 x 1 mesh.

:func:`spawn` takes the place of ``virtual_cpu_env``: it runs a function
on n ranks of a fresh world (processes started with ``spawn``) and
returns their results.  Its world meets through a ``FileStore`` in a
temporary directory (no TCP port, so several runs may share a host), its
gloo collectives time out after ``timeout_s``, and its join has a
deadline: a rank that raises, or a run past the deadline, kills every
rank and raises with the failing rank's traceback, so no rank is left
waiting in a collective.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import tempfile
import time

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_digit_mesh", "make_production_mesh",
           "init_world", "spawn", "SpawnError"]


def _backend_default() -> str:
    """nccl when every rank can have a card of its own, else gloo."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        n = int(os.environ.get("WORLD_SIZE", "1"))
        if n <= torch.cuda.device_count():
            return "nccl"
    return "gloo"


#: how long a collective of :func:`init_world`'s world may wait
WORLD_TIMEOUT_S = 300.0


def init_world(backend: str | None = None):
    """Join the world: the one ``torch.distributed.run`` started (its
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` variables), else a world of
    1 over a ``FileStore``.  Nothing happens when a process group exists.
    ``backend`` None: :func:`_backend_default`."""
    if dist.is_initialized():
        return
    backend = backend or _backend_default()
    timeout = datetime.timedelta(seconds=WORLD_TIMEOUT_S)
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, timeout=timeout)
        return
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(
        prefix="repro_torch_world_"), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=timeout)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the current world (started with
    :func:`init_world` if there is none): of "cuda" devices for an nccl
    world, of "cpu" ones for gloo (whose collectives take tensors of any
    device)."""
    from torch.distributed.device_mesh import init_device_mesh

    init_world()
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks; "
                         f"the world has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """JAX's production shapes: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_digit_mesh(n_model: int | None = None, *, n_data: int = 1):
    """The ``("data", "model")`` mesh of digit sharding: ``model`` carries
    RNS digit groups (size it to divide the profile's digit count), and
    ``data`` batch rows.  ``n_model=None`` takes every rank ``n_data``
    leaves."""
    init_world()
    n = dist.get_world_size()
    if n_model is None:
        if n % n_data:
            raise ValueError(f"{n} ranks not divisible by n_data={n_data}")
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"mesh ({n_data}, {n_model}) needs "
                         f"{n_data * n_model} ranks, the world has {n}")
    return make_mesh((n_data, n_model), ("data", "model"))


# ----------------------------------------------------------------- spawn --
class SpawnError(RuntimeError):
    """A rank of :func:`spawn` raised, died or outlived the deadline."""


def _rank_main(rank, n, fn, args, backend, device, timeout_s, root):
    out = os.path.join(root, f"rank{rank}.pt")
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count()
                                  if backend == "nccl" else 0)
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(root, "store"), n),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, n, *args)
        finally:
            if backend == "nccl":
                torch.cuda.synchronize()
        # no barrier here: a rank done early leaves its peers to finish
        # their own collectives; the group is torn down at exit
        torch.save(result, out + ".tmp")
        os.replace(out + ".tmp", out)
    except BaseException:
        import traceback

        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(n: int, fn, *args, backend: str = "gloo", device: str = "cpu",
          timeout_s: float = 120.0):
    """Run ``fn(rank, n, *args)`` on ``n`` ranks of a new world (one
    process each, started with ``spawn``; ``fn`` and ``args`` must pickle)
    and return the list of their results by rank (``torch.save``-able: CPU
    tensors, numbers, dicts).

    ``backend``: "gloo" (any device) or "nccl" (one rank a card);
    ``device``: "cuda" makes each rank's current device its card (with
    gloo every rank shares card 0).  ``timeout_s`` bounds each collective
    and the whole run: a rank that raises or dies, or a run past the
    deadline, kills every rank and raises :class:`SpawnError` with the
    failing rank's traceback."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    root = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(n, fn, args, backend, device, timeout_s, root),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise SpawnError(f"spawn: {n} ranks past the {timeout_s}"
                                     " s deadline" + _errors(root, n))
        except ProcessException as e:
            raise SpawnError(f"spawn: rank {e.error_index} failed"
                             + (_errors(root, n) or f"\n{e}")) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signal.SIGKILL)
                p.join(5)
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _errors(root: str, n: int) -> str:
    out = []
    for r in range(n):
        path = os.path.join(root, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"\n--- rank {r} ---\n{f.read()}")
    return "".join(out)

