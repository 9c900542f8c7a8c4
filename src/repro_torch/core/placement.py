"""Adapter placement over LoRA-Server devices (paper §4.1, Fig. 8), a copy
of ``repro.core.placement``.

The adapter space is the 3-D tensor (n_adapters x layers x experts); a
placement maps each (a, l, e) cell to a server device. Strategies:

  DP          : adapters striped over the m devices
  PP          : layers -> devices (interleaved: layer l -> l mod m)
  EP          : experts striped over the m devices
  EP_x-PP_y   : device grid (x, y); expert e -> e mod x, layer l -> l mod y
                (x*y == m). Paper's hybrid; x = intra-node degree default.

``owner`` answers "which device serves (a,l,e)"; ``layer_group`` gives the
sync scope per layer; both feed the cost model and the simulator.
``from_mesh_shape`` labels a serving mesh in placement terms.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Placement:
    strategy: str        # "dp" | "pp" | "ep" | "hybrid"
    m: int               # server device count
    n_adapters: int
    n_layers: int
    n_experts: int
    x: int = 1           # EP degree (hybrid)
    y: int = 1           # PP stages (hybrid)

    def __post_init__(self):
        if self.strategy == "hybrid" and self.x * self.y != self.m:
            raise ValueError(f"hybrid placement needs x * y == m, got "
                             f"{self.x} * {self.y} != {self.m}")

    @staticmethod
    def make(strategy: str, m: int, n_adapters: int, n_layers: int,
             n_experts: int, x: int = None) -> "Placement":
        n_experts = max(n_experts, 1)
        if strategy == "hybrid":
            x = x or min(4, m)  # paper default: intra-node GPU count
            while m % x:
                x -= 1
            return Placement(strategy, m, n_adapters, n_layers, n_experts,
                             x=x, y=m // x)
        if strategy == "ep":
            return Placement(strategy, m, n_adapters, n_layers, n_experts,
                             x=m, y=1)
        if strategy == "pp":
            return Placement(strategy, m, n_adapters, n_layers, n_experts,
                             x=1, y=m)
        return Placement(strategy, m, n_adapters, n_layers, n_experts)

    @classmethod
    def from_mesh_shape(cls, mesh_shape, n_adapters: int, n_layers: int,
                        n_experts: int) -> "Placement":
        """Label a serving mesh (``ServeConfig.mesh_shape`` = (data,
        model)) in placement terms: the decode rule-set stripes experts over
        "data", so the mesh runs the EP strategy at degree ``data``."""
        data, _ = mesh_shape
        return cls.make("ep", max(int(data), 1), n_adapters, n_layers,
                        n_experts)

    # ------------------------------------------------------------------ #
    def owner(self, adapter: int, layer: int, expert: int) -> int:
        """Device index serving cell (adapter, layer, expert)."""
        if self.strategy == "dp":
            return adapter % self.m
        if self.strategy == "pp":
            return layer % self.m
        if self.strategy == "ep":
            return expert % self.m
        # hybrid EP_x-PP_y: grid-major device id = stage * x + ep_rank
        stage = layer % self.y          # interleaved layers (paper §4.1)
        ep_rank = expert % self.x
        return stage * self.x + ep_rank

    def layer_group(self, layer: int) -> np.ndarray:
        """Devices that take part in one layer's LoRA step (sync scope)."""
        if self.strategy == "dp":
            return np.arange(self.m)
        if self.strategy == "pp":
            return np.array([layer % self.m])
        if self.strategy == "ep":
            return np.arange(self.m)
        stage = layer % self.y
        return stage * self.x + np.arange(self.x)

    def sync_scope(self) -> int:
        return len(self.layer_group(0))

    def experts_on(self, device: int) -> np.ndarray:
        """Global expert ids hosted by ``device`` (for its layers)."""
        e = np.arange(self.n_experts)
        if self.strategy in ("dp", "pp"):
            return e
        x = self.x if self.strategy == "hybrid" else self.m
        rank = device % x
        return e[e % x == rank]

    def layers_on(self, device: int) -> np.ndarray:
        l = np.arange(self.n_layers)
        if self.strategy in ("dp", "ep"):
            return l
        if self.strategy == "pp":
            return l[l % self.m == device]
        stage = device // self.x
        return l[l % self.y == stage]

    def cells_per_device(self) -> float:
        """Average adapter cells per device (load-balance sanity)."""
        total = self.n_adapters * self.n_layers * self.n_experts
        return total / self.m

    def describe(self) -> str:
        if self.strategy == "hybrid":
            return f"EP{self.x}-PP{self.y}"
        return {"dp": "DP", "pp": f"EP1-PP{self.m}",
                "ep": f"EP{self.m}-PP1"}[self.strategy]
