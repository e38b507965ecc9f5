"""Named-axis rank topology → process groups.

Counterpart of ``deepspeed_tpu/parallel/topology.py``. The rank arithmetic
(``ProcessTopology`` and its pipe/model/data subclasses, ``MeshSpec``,
``mesh_axis_size``, ``dp_axis_names``) is the same code; where the JAX
package materializes a ``jax.sharding.Mesh``, this one builds
:class:`ProcessGroups`: for each axis, one ``torch.distributed`` group per
slice of that axis (``get_axis_comm_lists``), made by every rank in the
same order, of which each rank keeps the one it belongs to. The
collectives of ``comm/`` take those groups where JAX's take axis names.

Canonical axis names (any subset may be present, sizes default to 1):
``pp`` pipeline stages, ``dp`` data parallel (ZeRO shards over it), ``tp``
tensor parallel, ``ep`` expert parallel, ``sp`` sequence parallel. Only
``dp`` may exceed 1 here: the others raise :class:`NotPortedError`
(ROADMAP queue 1 items 11b for tp, 12b pp, 12c sp, 12d ep).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..runtime.config import NotPortedError

CANONICAL_AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")

# the ROADMAP queue 1 item that ports each axis still refused beyond size 1
_AXIS_ITEMS = {"pp": "12b", "ep": "12d"}


class ProcessTopology:
    """Cartesian mapping of named parallelism axes onto a flat rank list
    (the reference's ``ProcessTopology``: rank↔coord queries, axis comm
    lists); :meth:`get_mesh` makes the process groups."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int], devices: Optional[Sequence] = None):
        assert len(axes) == len(dims), "axes and dims must align"
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = collections.namedtuple("ProcessCoord", axes)
        self.mapping: Dict[Tuple[int, ...], int] = {}
        for global_rank, coord in enumerate(itertools.product(*[range(d) for d in dims])):
            self.mapping[coord] = global_rank
        self._devices = devices

    def world_size(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 1

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 1

    def get_rank(self, **coord_kwargs) -> int:
        key = tuple(coord_kwargs[a] for a in self.axes)
        assert key in self.mapping, f"invalid coord {coord_kwargs}"
        return self.mapping[key]

    def get_coord(self, rank: int):
        for coord, r in self.mapping.items():
            if r == rank:
                return self.ProcessCoord(*coord)
        raise ValueError(f"rank {rank} not in topology")

    def get_rank_repr(self, rank: int, omit_axes=("dp", "pp"), inner_sep="_", outer_sep="-") -> str:
        omit_axes = list(omit_axes)
        axes = [a for a in self.axes if a not in omit_axes]
        coord = self.get_coord(rank)
        return outer_sep.join(f"{ax}{inner_sep}{getattr(coord, ax):02d}" for ax in axes)

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        """All ranks whose ``axis`` coordinate equals ``idx``."""
        pos = self.axes.index(axis)
        return sorted(r for coord, r in self.mapping.items() if coord[pos] == idx)

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """The rank lists that form communicators along ``axis`` (reference
        topology.py:155): one :class:`ProcessGroups` group each."""
        if axis not in self.axes:
            return []
        pos = self.axes.index(axis)
        other_ranges = [range(d) for i, d in enumerate(self.dims) if i != pos]
        lists = []
        for other in itertools.product(*other_ranges):
            ranks = []
            for v in range(self.dims[pos]):
                coord = list(other)
                coord.insert(pos, v)
                ranks.append(self.mapping[tuple(coord)])
            lists.append(sorted(ranks))
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        def match(coord):
            return all(getattr(coord, k) == v for k, v in filter_kwargs.items())

        return sorted(r for coord, r in self.mapping.items() if match(self.ProcessCoord(*coord)))

    def get_mesh(self, devices: Optional[Sequence] = None) -> "ProcessGroups":
        """This topology's process groups (JAX: its ``Mesh``)."""
        return ProcessGroups(self)

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeModelDataParallelTopology(ProcessTopology):
    """3D pp×dp×tp topology; analog of reference topology.py:243."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int, devices=None):
        super().__init__(axes=["pp", "dp", "tp"], dims=[num_pp, num_dp, num_mp], devices=devices)


class PipeDataParallelTopology(ProcessTopology):
    def __init__(self, num_pp: int, num_dp: int, devices=None):
        super().__init__(axes=["pp", "dp"], dims=[num_pp, num_dp], devices=devices)


class ProcessGroups:
    """The port's mesh: the axis sizes (``shape``, ``axis_names``, as a
    JAX ``Mesh`` has them) and, for each axis, the ``torch.distributed``
    group of this rank's slice (:meth:`group`). Every rank must build it,
    in the same order (``dist.new_group`` is collective). Without an
    initialized process group (one process, no ``init_distributed``) the
    axes have size 1 and no groups: ``distributed`` is False and nothing
    communicates."""

    def __init__(self, topology: ProcessTopology):
        for axis, d in zip(topology.axes, topology.dims):
            if axis in _AXIS_ITEMS and d > 1:
                raise NotPortedError(
                    f"mesh axis {axis}={d}: only the dp, sp and tp axes are ported to "
                    f"deepspeed_tpu_torch (ROADMAP queue 1 item {_AXIS_ITEMS[axis]})")
        self.topology = topology
        self.axis_names = tuple(topology.axes)
        self.shape = dict(zip(topology.axes, topology.dims))
        self.distributed = dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        if topology.world_size() != world:
            raise ValueError(f"topology {topology} covers {topology.world_size()} ranks but "
                             f"the process group has {world}")
        me = dist.get_rank() if self.distributed else 0
        self.rank = me
        self._groups: Dict[str, object] = {}
        if self.distributed:
            from ..comm.torch import name_group

            for axis in self.axis_names:
                for ranks in topology.get_axis_comm_lists(axis):
                    g = dist.new_group(ranks)
                    if me in ranks:
                        self._groups[axis] = g
                        name_group(g, axis)

    def group(self, axis: str):
        """This rank's group along ``axis`` (KeyError without one)."""
        return self._groups[axis]

    def group_or_none(self, axis: str):
        """This rank's group along ``axis`` when the axis exceeds 1 and a
        process group exists, else None (nothing to communicate)."""
        return self._groups.get(axis) if self.size(axis) > 1 else None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return getattr(self.topology.get_coord(self.rank), axis) if axis in self.shape else 0

    def __repr__(self):
        return f"ProcessGroups({self.shape}, distributed={self.distributed})"


@dataclass
class MeshSpec:
    """Declarative mesh request: axis name → size; -1 means "fill the
    remaining ranks". ``devices``: the ranks to cover (default: the whole
    process group, or one rank without one)."""

    dp: int = -1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    axis_order: Tuple[str, ...] = CANONICAL_AXIS_ORDER
    devices: Optional[Sequence] = None

    def resolve(self, n_devices: Optional[int] = None) -> ProcessTopology:
        if self.devices is not None:
            devices = list(self.devices)
        else:
            devices = list(range(dist.get_world_size() if dist.is_initialized() else 1))
        n = n_devices if n_devices is not None else len(devices)
        sizes = {"dp": self.dp, "tp": self.tp, "pp": self.pp, "ep": self.ep, "sp": self.sp}
        fixed = int(np.prod([v for v in sizes.values() if v > 0]))
        n_fill = sum(1 for v in sizes.values() if v == -1)
        assert n_fill <= 1, "at most one axis may be -1"
        if n_fill:
            assert n % fixed == 0, f"{n} devices not divisible by fixed axes product {fixed}"
            fill_val = n // fixed
            sizes = {k: (fill_val if v == -1 else v) for k, v in sizes.items()}
        total = int(np.prod(list(sizes.values())))
        assert total == n, f"mesh {sizes} covers {total} devices but {n} are available"
        axes = [a for a in self.axis_order if sizes[a] > 1] or ["dp"]
        dims = [sizes[a] for a in axes]
        return ProcessTopology(axes=axes, dims=dims, devices=devices[:n])

    def build_mesh(self, n_devices: Optional[int] = None) -> ProcessGroups:
        return self.resolve(n_devices).get_mesh()


def mesh_axis_size(mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1) if axis else 1


def dp_axis_names(mesh) -> Tuple[str, ...]:
    """Axes grads are averaged over: dp (and sp — batch is also split over sp)."""
    return tuple(a for a in ("dp", "sp") if a in mesh.axis_names)


_ACTIVE: List[object] = []


@contextlib.contextmanager
def active_mesh(mesh):
    """Make ``mesh`` the :func:`current_mesh` inside the block (the engine
    wraps each training and eval step's loss in its mesh)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current_mesh():
    """The innermost :func:`active_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def single_device_mesh() -> ProcessGroups:
    """The one-rank mesh (a world-1 process group, or none)."""
    return ProcessTopology(["dp"], [1]).get_mesh()
