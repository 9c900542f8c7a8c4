"""Mesh builders, the counterpart of ``repro.launch.mesh``.

Two kinds of mesh:

- ``Mesh``, the serving plane's: a grid of ``torch.device``s driven by
  one controller. That plane needs no collective (only rows and outputs
  move between positions), so it needs no process group.
  ``make_serve_mesh`` takes the first ``data * model`` distinct visible
  CUDA cards by default; ``devices=["cpu"]`` makes every position the CPU
  (the counterpart of the reference's forced host devices, which the CPU
  tests use), and an explicit ``devices=`` list may name one card more
  than once (a grid on one card).
- ``ProcessMesh``, the SPMD steps': one process a position of the grid,
  over the current ``torch.distributed`` world (gloo on the CPU, NCCL on
  the cards, one card a rank). Rank r sits at the row-major position r
  of the grid. The mesh makes one process group for every set of its
  axes (``get_group``), so a collective over a named axis, or a tuple of
  them, runs among the ranks that differ only there.
  ``make_debug_mesh`` and ``make_production_mesh`` build one with the
  reference's shapes and axis names, and raise a ``ValueError`` naming
  the world size they need when the world has another.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


# why the coupled plane takes no mesh (the reference's words)
COUPLED_UNDER_MESH = ("the coupled step's allgather MoE reassociates floats "
                      "under a mesh, breaking the token bit-identity "
                      "invariant")


def check_mesh_shape(mesh_shape, disaggregated: bool) -> None:
    """The reference's checks of a serving ``mesh_shape``, shared by
    ``ServeConfig`` and ``Cluster``: the disaggregated plane only, and two
    positive ints (data, model)."""
    if not disaggregated:
        raise ValueError(f"mesh_shape requires disaggregated=True: "
                         f"{COUPLED_UNDER_MESH}")
    if len(mesh_shape) != 2 or any(int(d) < 1 for d in mesh_shape):
        raise ValueError(f"mesh_shape must be two positive ints (data, "
                         f"model), got {mesh_shape!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A device grid: ``devices`` is an object array of ``torch.device``
    whose shape gives each axis of ``axis_names`` its size."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device of position (0, ..., 0): where everything that is
        not sharded lives."""
        return self.devices.flat[0]


def grid(devices: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    """An object array of ``torch.device`` of ``shape``: a one-device list
    fills every position, a longer one gives its first n in order."""
    n = int(np.prod(shape))
    devs = [torch.device(d) for d in devices]
    if len(devs) == 1:
        devs = devs * n
    if len(devs) < n:
        raise ValueError(f"a grid of shape {tuple(shape)} needs {n} devices, "
                         f"{len(devs)} given")
    out = np.empty(n, dtype=object)
    out[:] = devs[:n]
    return out.reshape(shape)


def make_serve_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """Serving-plane mesh of axes ("data", "model"), the shape
    ``ServeConfig.mesh_shape`` maps to. The decode rule-set puts experts on
    "data", so (2, 1) is pure expert parallelism. Without ``devices`` it
    takes the first ``data * model`` distinct visible CUDA cards and
    raises the reference's error when there are fewer."""
    if devices is None:
        devices = visible_cards(data * model,
                                f"mesh_shape ({data}, {model})")
    return Mesh(grid(devices, (data, model)), ("data", "model"))


def visible_cards(n: int, what: str):
    """The first ``n`` distinct visible CUDA cards; ``what`` names the grid
    in the error raised when there are fewer."""
    k = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > k:
        raise ValueError(
            f"{what} needs {n} devices but only {k} are visible; on the CPU "
            f"pass devices=['cpu'], on one card name it once a position")
    return [torch.device("cuda", i) for i in range(n)]


def carve_server_submesh(mesh: Mesh, x: int, y: int) -> Mesh:
    """The trailing x*y positions of ``mesh`` as a LoRA-Server mesh of axes
    ("ep", "pp"): disaggregation as disjoint submeshes."""
    flat = mesh.devices.reshape(-1)
    if x * y > flat.size:
        raise ValueError(f"a {x}x{y} server mesh needs {x * y} positions, "
                         f"the mesh has {flat.size}")
    return Mesh(flat[-x * y:].reshape(x, y), ("ep", "pp"))


def instance_submesh(mesh: Mesh, n_server: int, data: int,
                     model: int) -> Mesh:
    """The LoRA-free LLM instance's share of ``mesh``: its leading
    ``data * model`` positions, axes ("data", "model")."""
    flat = mesh.devices.reshape(-1)
    n = data * model
    if n + n_server > flat.size:
        raise ValueError(f"{n} instance and {n_server} server positions do "
                         f"not fit a mesh of {flat.size}")
    return Mesh(flat[:n].reshape(data, model), ("data", "model"))


# ------------------------- the SPMD steps' mesh ------------------------- #
@dataclasses.dataclass(eq=False)
class ProcessMesh:
    """A grid of processes: ``devices`` is an int array of global ranks
    (``np.arange(world).reshape(shape)``) whose shape gives each axis of
    ``axis_names`` its size, as the reference's ``Mesh.devices`` gives
    its rules the axis sizes; ``rank`` is this process's. ``groups`` maps
    a tuple of axes (in mesh order) to this rank's process group over
    them, or None where the group is this rank alone."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    rank: int
    groups: Dict[Tuple[str, ...], object]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def _axes(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a not in self.axis_names for a in names):
            raise ValueError(f"axes {names} not all in mesh axes "
                             f"{self.axis_names}")
        order = [self.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"axes {names} must be in mesh order "
                             f"{self.axis_names}")
        return names

    def size(self, axes) -> int:
        """The number of positions along ``axes`` (a name or a tuple)."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def coord(self, axes) -> int:
        """This rank's index along ``axes``: its row-major position over
        them (the first axis major), the order of a tiled gather."""
        pos = dict(zip(self.axis_names,
                       np.unravel_index(self.rank, self.devices.shape)))
        out = 0
        for a in self._axes(axes):
            out = out * self.shape[a] + int(pos[a])
        return out

    def get_group(self, axes):
        """This rank's process group over ``axes``, None for a group of
        one (a collective over it is the identity)."""
        return self.groups[self._axes(axes)]


def make_process_mesh(shape: Sequence[int], axis_names: Sequence[str]):
    """A ``ProcessMesh`` of ``shape`` over the current process group. Every
    rank must call it, in the same order: it creates one process group for
    each set of axes and each choice of the other axes' positions."""
    import torch.distributed as dist
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} axis names, "
                         f"got {names}")
    need = int(np.prod(shape))
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"a process mesh of shape {shape} needs a "
                           f"torch.distributed process group of {need} "
                           f"ranks; none is initialised")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a process mesh of shape {shape} ({names}) needs a "
                         f"world of {need} processes, this one has {world}")
    ranks = np.arange(world).reshape(shape)
    me = dist.get_rank()
    groups: Dict[Tuple[str, ...], object] = {}
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(range(len(names)), k):
            axes = tuple(names[i] for i in sub)
            # the ranks that differ only along ``sub``: one group for each
            # position of the other axes, made by every rank in one order
            moved = np.moveaxis(ranks, sub, tuple(range(-k, 0)))
            members = moved.reshape(-1, int(np.prod([shape[i]
                                                     for i in sub])))
            groups[axes] = None
            for row in members:
                row = [int(r) for r in row]
                if len(row) == 1:
                    continue
                g = dist.group.WORLD if len(row) == world else \
                    dist.new_group(row)
                if me in row:
                    groups[axes] = g
    return ProcessMesh(ranks, names, me, groups)


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The reference's production mesh over the current world: (16, 16)
    ("data", "model"), or (2, 16, 16) with "pod" ahead."""
    if multi_pod:
        return make_process_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_process_mesh((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 4,
                    pod: int = 0) -> ProcessMesh:
    """A small mesh for tests, (data, model) or (pod, data, model), over
    the current world (which must have exactly that many ranks)."""
    if pod:
        return make_process_mesh((pod, data, model), ("pod", "data", "model"))
    return make_process_mesh((data, model), ("data", "model"))
