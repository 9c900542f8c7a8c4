"""Client<->server transfer protocol model (paper §5.1), a copy of
``repro.core.protocol`` priced with the nominal ``H100`` by default.

The paper uses IBGDA one-sided RDMA: push-based writes beat pull-based
reads by 2.63x at 4 MB, because pull adds local client coordination, a
notification round trip and a server-side sync before the remote read
(Fig. 9). Push is a sender-initiated write into a preallocated remote
buffer; pull adds a control round trip plus a sync fence across the
server's sync scope. Both are modelled so the simulator can price either.
"""
from __future__ import annotations

from repro_torch.core.cost_model import H100, Hardware

# Control-message cost (one small message) and per-device sync fence.
CTRL_BYTES = 256
SYNC_PER_DEVICE = 0.4e-6  # s, barrier cost per participating device
# One-sided *reads* are request/response per chunk and cannot pipeline as
# deeply as writes; effective read throughput is a fraction of link bw.
# Calibrated so pull/push ~= 2.6x at 4 MB (paper §5.1 measures 2.63x).
PULL_READ_EFF = 0.4


def transfer_seconds(payload_bytes: float, hw: Hardware = H100,
                     inter_pod: bool = False, protocol: str = "push",
                     peers: int = 1, sync_scope: int = 1) -> float:
    """One hook-point transfer of ``payload_bytes`` (already per-device).

    push: sender-initiated write into a preallocated remote buffer; the
          receiver's persistent poller adds no wire time (paper Fig. 9 top).
    pull: client-side coordination + notify + server sync + remote read:
          one extra round trip and a sync fence over the sync scope.
    """
    bw, lat = hw.link(inter_pod)
    per_peer = payload_bytes / max(peers, 1)
    wire = lat + per_peer / bw
    if protocol == "push":
        return wire * 1.0 + (peers - 1) * lat * 0.25  # serialization of peers
    if protocol == "pull":
        ctrl = 2 * (lat + CTRL_BYTES / bw)            # notify + read request
        sync = SYNC_PER_DEVICE * max(sync_scope, 1) + lat
        wire_read = lat + per_peer / (bw * PULL_READ_EFF)
        return ctrl + sync + wire_read + (peers - 1) * lat * 0.25
    raise ValueError(protocol)


def pull_push_ratio(payload_bytes: float = 4 * 2**20,
                    hw: Hardware = H100) -> float:
    """Paper calibration point: ~2.63x at 4 MB payloads."""
    return (transfer_seconds(payload_bytes, hw, protocol="pull", sync_scope=4)
            / transfer_seconds(payload_bytes, hw, protocol="push"))
