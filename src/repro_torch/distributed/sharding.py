"""Mesh axes, digit sharding and the collectives of the port.

The port of ``repro.distributed.sharding``.  A JAX mesh axis is a
``torch.distributed`` process group here, and the mesh a
``torch.distributed.device_mesh.DeviceMesh`` with the dimensions
``("data", "model")`` (``launch/mesh.py``).  Each rank is one process
that runs the whole program.

* **Rules** (:data:`RULES`, :func:`spec_for_axes`, :func:`first_valid_spec`,
  :func:`dp_axes`, :func:`dp_size`, :func:`batch_spec`): pure functions of
  axis names and sizes, as JAX's.  A spec is a tuple of mesh axis names
  (or tuples of them, or None) a dimension, JAX's ``PartitionSpec`` as a
  tuple.  They read a mesh's axis names and sizes only, so a
  ``DeviceMesh``, a JAX mesh or any object with ``axis_names`` and a
  ``shape`` mapping serves.  (Placing parameters and activations by them,
  GSPMD's FSDP / TP layouts, ``tree_shardings`` and ``constrain``, is
  not ported: ROADMAP A.11.)
* **Digit sharding** (:class:`DigitSharding`, installed per thread with
  :class:`use_digit_sharding`): RNS digits carry nothing between them, so
  a K-digit register splits into K/n moduli a rank of the ``model``
  group.  Float work runs on every rank of the group alike; a residue
  tensor holds only the rank's digit group ``[lo:hi)``, ``[K/n, ...]``.
  ``core/dispatch.py`` runs convert and matmul on the local moduli with
  no communication and gathers the digits once, in normalize.
* **Batch sharding** (:class:`use_batch_sharding`): a data-parallel
  step's rows are split over the ``data`` group; every whole-tensor
  absmax scale (``core/quantize.absmax_scale``) is then the max over the
  group, as GSPMD's global reduction over the batch gives it.

Every collective of the port goes through this module and is counted
(:func:`collective_counts`): :func:`gather_digits` (the only collective
on the digit axis), and, on the data group, :func:`all_reduce_sum` (the
gradients, the loss) and :func:`all_reduce_max` (the scales).

Backends: ``gloo`` takes tensors of any device, and its collectives go
through the host (a CUDA tensor is copied to host memory and back here),
so a step that holds one cannot be captured in a CUDA graph
(:func:`check_capturable` raises); ``nccl`` takes one rank a device, and
its collectives can be captured.  The backend is the group's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.distributed as dist

__all__ = ["RULES", "spec_for_axes", "first_valid_spec", "dp_axes",
           "dp_size", "batch_spec", "axis_sizes", "DigitSharding",
           "use_digit_sharding", "digit_sharding", "use_batch_sharding",
           "batch_group", "snapshot", "restore", "backend_of",
           "check_capturable", "gather_digits", "all_reduce_sum",
           "all_reduce_max", "collective_counts", "reset_collective_counts"]

# candidate mesh axes per logical axis name, in preference order (JAX's)
RULES: dict[str | None, tuple[str, ...]] = {
    "batch": ("data",),
    "embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model", "data"),
    "expert": ("model",),
    # lora ranks are contraction dims of every MLA up-projection: never
    # sharded
    "lora": (),
    # the leading [K, ...] digit axis of residue tensors
    "digit": ("model",),
    "embed_vec": (),
    "expert_vec": (),
    "layers": (),
    None: (),
}


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``) or of a
    JAX-style mesh (``axis_names`` and a ``shape`` mapping)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def spec_for_axes(axes, shape, mesh) -> tuple:
    """One parameter's logical axes -> a spec: the first candidate axis
    of each dimension that is in the mesh, unused by an earlier dimension
    and divides it."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for name, dim in zip(axes, shape):
        pick = None
        for c in RULES.get(name, ()):
            if (c in sizes and c not in used and dim % sizes[c] == 0
                    and dim >= sizes[c]):
                pick = c
                break
        if pick:
            used.add(pick)
        out.append(pick)
    return tuple(out)


def dp_axes(mesh) -> tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def dp_size(mesh) -> int:
    return _axis_size(axis_sizes(mesh), dp_axes(mesh))


def batch_spec(mesh) -> tuple:
    """Rows over the data axes (one axis by its name, as JAX's
    ``PartitionSpec`` writes it)."""
    axes = dp_axes(mesh)
    return (axes[0] if len(axes) == 1 else axes or None, None)


def first_valid_spec(shape, candidates, mesh) -> tuple:
    """The first candidate spec whose sharded dimensions all divide."""
    sizes = axis_sizes(mesh)
    for spec in candidates:
        ok = True
        for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
            n = _axis_size(sizes, axis)
            if n > 1 and (dim % n != 0 or dim < n):
                ok = False
                break
        if ok:
            return tuple(spec)
    return (None,) * len(shape)


# ------------------------------------------------------------ groups ----
def backend_of(group) -> str:
    """"gloo" or "nccl": the backend of ``group``."""
    return str(dist.get_backend(group))


def check_capturable(mesh, axes, device, graphs: bool):
    """Raise where a step on ``device`` would capture (``graphs`` on the
    card) a collective of a gloo group: gloo's collectives go through the
    host, which a CUDA graph cannot hold."""
    if mesh is None or not graphs or torch.device(device).type != "cuda":
        return
    for axis in axes:
        if backend_of(mesh.get_group(axis)) == "gloo":
            raise ValueError(
                f"the {axis!r} group of the mesh is gloo, whose "
                "collectives go through the host and cannot be captured "
                "in a CUDA graph: pass graphs=False (the CLIs' --eager), "
                "or run one rank a card over nccl")


# ------------------------------------------------------- digit sharding --
@dataclasses.dataclass(frozen=True)
class DigitSharding:
    """The digit axis of ``[K, ...]`` residue tensors over the mesh axis
    ``axis``: the rank at index i of that group holds moduli
    ``[i K/n, (i+1) K/n)`` of a profile whose K divides n; a profile that
    does not divide stays whole on every rank."""

    mesh: object
    axis: str = "model"

    @property
    def n_shards(self) -> int:
        return int(axis_sizes(self.mesh)[self.axis])

    @property
    def index(self) -> int:
        """This rank's index in the digit group."""
        return int(self.mesh.get_local_rank(self.axis))

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    @property
    def backend(self) -> str:
        return backend_of(self.group)

    def shards(self, n_digits: int) -> bool:
        """Whether a K-digit profile splits evenly over the axis."""
        return n_digits % self.n_shards == 0

    def bounds(self, n_digits: int) -> tuple[int, int]:
        """This rank's digit group ``[lo, hi)`` of a K-digit profile."""
        w = n_digits // self.n_shards
        return self.index * w, (self.index + 1) * w

    def local_profile(self, profile):
        """The digit-group profile this rank holds of ``profile``."""
        from repro_torch.core.moduli import digit_group, get_profile

        p = get_profile(profile)
        return digit_group(p.name, *self.bounds(p.n_digits))

    def digit_spec(self, ndim: int, axis_pos: int = 0) -> tuple:
        """The spec of a residue tensor: the digit axis (at ``axis_pos``:
        0 for ``[K, ...]``, 1 for period-major ``[P, K, ...]``) over
        ``axis``, every other dimension whole."""
        spec = [None] * ndim
        spec[axis_pos] = self.axis
        return tuple(spec)

    def local(self, digits: torch.Tensor, axis_pos: int = 0):
        """This rank's digit group of a whole ``[.., K, ..]`` tensor (a
        contiguous copy, so the whole tensor can be freed)."""
        lo, hi = self.bounds(digits.shape[axis_pos])
        return digits.narrow(axis_pos, lo, hi - lo).contiguous()


_state = threading.local()      # per thread: two engines, one sharded


class use_digit_sharding:
    """Install the digit layout of ``mesh``'s ``axis`` for the block (per
    thread, nestable: the innermost wins); ``mesh=None`` does nothing."""

    def __init__(self, mesh, axis: str = "model"):
        self.ds = DigitSharding(mesh, axis) if mesh is not None else None

    def __enter__(self):
        self._prev = getattr(_state, "ds", None)
        if self.ds is not None:
            _state.ds = self.ds
        return self.ds

    def __exit__(self, *exc):
        _state.ds = self._prev
        return False


def digit_sharding() -> DigitSharding | None:
    """The installed digit layout, or None."""
    return getattr(_state, "ds", None)


class use_batch_sharding:
    """Rows split over ``mesh``'s ``data`` axis for the block: every
    whole-tensor absmax scale becomes the max over the data group
    (:func:`all_reduce_max`).  ``mesh=None`` (or one data rank) does
    nothing."""

    def __init__(self, mesh):
        self.group = None
        if mesh is not None and axis_sizes(mesh).get("data", 1) > 1:
            self.group = mesh.get_group("data")

    def __enter__(self):
        self._prev = getattr(_state, "batch", None)
        if self.group is not None:
            _state.batch = self.group
        return self.group

    def __exit__(self, *exc):
        _state.batch = self._prev
        return False


def batch_group():
    """The installed data group of a batch-sharded step, or None."""
    return getattr(_state, "batch", None)


def snapshot() -> tuple:
    """This thread's layouts, to install on another thread: autograd runs
    a CUDA backward on a thread of its own, where the forward's contexts
    are not installed."""
    return (digit_sharding(), batch_group())


@contextlib.contextmanager
def restore(snap: tuple):
    """Install a :func:`snapshot` for the block."""
    prev = snapshot()
    _state.ds, _state.batch = snap
    try:
        yield
    finally:
        _state.ds, _state.batch = prev


# ----------------------------------------------------------- collectives --
_counts = {"gather_digits": 0, "all_reduce_sum": 0, "all_reduce_max": 0}
_count_lock = threading.Lock()


def _count(name: str):
    with _count_lock:
        _counts[name] += 1


def collective_counts() -> dict[str, int]:
    """Collectives made by this process since the last reset, by name."""
    return dict(_counts)


def reset_collective_counts():
    with _count_lock:
        for k in _counts:
            _counts[k] = 0


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and backend_of(group) == "gloo"


def gather_digits(ds: DigitSharding, res: torch.Tensor) -> torch.Tensor:
    """The whole ``[K, ...]`` residue tensor from every rank's digit group
    ``[K/n, ...]``, in rank order: THE collective of the digit axis, one
    a normalize."""
    _count("gather_digits")
    group, n = ds.group, ds.n_shards
    src = res.contiguous()
    staged = _host_staged(group, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(res.device) if staged else out


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if _host_staged(group, t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (the gradients, the loss)."""
    _count("all_reduce_sum")
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Max of ``t`` over ``group`` in place (a whole-tensor scale's
    absmax, over the data group)."""
    _count("all_reduce_max")
    return _all_reduce(t, dist.ReduceOp.MAX, group)
