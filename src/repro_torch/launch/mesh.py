"""Serving-mesh builders, the counterpart of ``repro.launch.mesh``.

The port's mesh is a grid of ``torch.device``s driven by one controller:
the serving plane's mesh needs no collective (only rows and outputs move
between positions), so it needs no process group. ``make_serve_mesh``
takes the first ``data * model`` distinct visible CUDA cards by default;
``devices=["cpu"]`` makes every position the CPU (the counterpart of the
reference's forced host devices, which the CPU tests use), and an explicit
``devices=`` list may name one card more than once (a grid on one card).

The training meshes (``make_production_mesh``, ``make_debug_mesh``) come
with the collective-bearing SPMD steps (ROADMAP A8b, A9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

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
