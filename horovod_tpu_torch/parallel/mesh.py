"""The device mesh over the job's ranks — counterpart of
``horovod_tpu/parallel/mesh.py``.

A JAX ``Mesh`` lays chips out on named axes; a strategy names an axis and
XLA routes its collectives. The port's ``Mesh`` lays the job's ranks (one
GPU each) out the same way, row-major with the rightmost axis fastest, so
``tp``/``sp`` groups are neighbouring ranks (one host's GPUs) and
``dp``/``pp`` span them:

    dp   — data parallel          (the runtime's averaged gradients)
    fsdp — fully-sharded DP       (all_gather params / reduce_scatter grads)
    tp   — tensor parallel        (sums of partial products)
    pp   — pipeline parallel      (neighbour exchange of activations)
    sp   — sequence/context par.  (ring exchange / Ulysses all_to_all)
    ep   — expert parallel        (all_to_all token dispatch)

For each axis and each choice of the other coordinates, the ranks along the
axis form one process set (``hvd.add_process_set``): ``mesh.group(axis)``
is this rank's set's ``group`` (the caller's ``torch.distributed`` group)
and ``mesh.process_set(axis)`` the set, whose negotiated runtime carries
the axis's gradient average (``DistributedOptimizer(process_set=...)``).
An axis over the whole world is the global set. Every rank makes every
set, in the same order: ``add_process_set`` is collective over the world.
"""

from __future__ import annotations

import math

import numpy as np

KNOWN_AXES = ("dp", "fsdp", "pp", "sp", "ep", "tp")


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """Parse ``"dp=4,tp=2"`` (the HOROVOD_TPU_MESH env format)."""
    out: dict[str, int] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, v = part.split("=")
        out[k.strip()] = int(v)
    return out


def rank_grid(shape) -> np.ndarray:
    """The global rank at each mesh coordinate: ``arange`` laid out
    row-major, the rightmost axis fastest."""
    return np.arange(math.prod(shape), dtype=np.int64).reshape(tuple(shape))


def axis_groups(grid: np.ndarray, axis: int) -> list[list[int]]:
    """The rank lists along ``axis``: one for each choice of the other
    coordinates, in row-major order of those coordinates."""
    moved = np.moveaxis(grid, axis, -1)
    return [list(map(int, row)) for row in moved.reshape(-1, grid.shape[axis])]


class Mesh:
    """Named axes over the job's ranks. ``devices`` is the rank grid (the
    counterpart of ``jax.sharding.Mesh.devices``); ``coords[axis]`` this
    rank's coordinate; ``size(axis)`` an axis's length."""

    def __init__(self, axes: dict[str, int]):
        from ..common import context

        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.devices = rank_grid(tuple(axes.values()))
        world, me = context.size(), context.rank()
        if self.devices.size != world:
            raise ValueError(f"mesh {axes} needs {self.devices.size} ranks, "
                             f"have {world}")
        where = np.argwhere(self.devices == me)[0]
        self.coords = {a: int(c) for a, c in zip(self.axis_names, where)}
        self._sets = {}
        for k, name in enumerate(self.axis_names):
            for ranks in axis_groups(self.devices, k):
                ps = (context.global_process_set() if len(ranks) == world
                      else context.add_process_set(ranks))
                if me in ranks:
                    self._sets[name] = ps

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def process_set(self, axis: str):
        """The process set of this rank's ranks along ``axis``."""
        return self._sets[axis]

    def group(self, axis: str):
        """The ``torch.distributed`` group of this rank's ranks along
        ``axis`` (a group of one where the axis has length 1)."""
        return self._sets[axis].group

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def create_mesh(axes: dict[str, int] | str | None = None) -> Mesh:
    """A mesh with named axes over every rank of the job (``hvd.init()``
    first). ``None`` is one ``dp`` axis over the world. Put ``tp``/``sp``
    (every-layer collectives) rightmost so their groups are neighbouring
    ranks, ``dp``/``pp`` (once a step) leftmost."""
    from ..common import context

    if isinstance(axes, str):
        axes = parse_mesh_spec(axes)
    if not axes:
        axes = {"dp": context.size()}
    return Mesh(axes)


def create_hierarchical_mesh(ici_axes: dict[str, int],
                             dcn_axes: dict[str, int]) -> Mesh:
    """A two-level mesh: ``dcn_axes`` span hosts, ``ici_axes`` a host's
    GPUs. The launcher numbers ranks host by host, so the ici axes, put
    rightmost, group one host's ranks: a sum over the ici axis and then the
    dcn axis is the reference's hierarchical allreduce (a reduction inside
    the host, then across hosts)."""
    return Mesh({**dcn_axes, **ici_axes})
