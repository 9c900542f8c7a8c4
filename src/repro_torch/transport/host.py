"""Host-mediated transport: the eager decode step with the reference's
launch accounting (``repro.transport.host``).

Every MoE layer's two hook points call back into Python
(``ServerPool.compute`` -> one ``bgmv_expert`` launch per engaged replica),
so the host launches the step kernel by kernel. Each hook call counts one
hook dispatch and one host dispatch per engaged replica; the token select
counts one more on the paged layout, the dense layout's gather, scatter
and select three. The reference copies the rows to the host before each
server call; the port's server resolves slots on the card, so the
activations stay there.
"""
from __future__ import annotations

from repro_torch.transport.base import TransportStats, eager_step


class _CountingServer:
    """Delegating proxy that bills each hook call's server launches to the
    transport's stats: a ``ServerPool`` reports them (``replica_launches``),
    a bare ``LoRAServer`` launches once a call."""

    def __init__(self, server, stats: TransportStats):
        self._server = server
        self._stats = stats

    def compute(self, hook, layer, rows, adapter_ids, expert_ids):
        before = getattr(self._server, "replica_launches", None)
        out = self._server.compute(hook, layer, rows, adapter_ids,
                                   expert_ids)
        launches = 1 if before is None else \
            max(self._server.replica_launches - before, 1)
        self._stats.hook_dispatches += 1
        self._stats.host_dispatches += launches
        return out


class HostTransport:
    """Per-hook host dispatch (the measurable baseline plane)."""

    name = "host"

    def __init__(self, server):
        self.server = server
        self.stats = TransportStats(transport="host")
        self._counting = _CountingServer(server, self.stats)

    def decode_step(self, params, cfg, k, v, toks, pos_vec, adapter_ids,
                    lora_scale, *, sel=None, scatter_idx=None,
                    block_table=None):
        st = self.stats
        st.steps += 1
        st.observe_ranks(self.server, adapter_ids)
        route = getattr(self.server, "route_step", None)
        if route is not None:
            route(adapter_ids)
        try:
            tok = eager_step(params, cfg, k, v, toks, pos_vec,
                             self._counting, adapter_ids, lora_scale, sel,
                             scatter_idx, block_table)
        finally:
            if route is not None:
                route(None)
        st.host_dispatches += 1 if block_table is not None else 3
        return tok, k, v

    def forget_kv(self, k, v) -> None:
        """Nothing is kept per KV buffer on this plane."""
