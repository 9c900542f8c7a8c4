"""Transport planes of the disaggregated decode step (paper §5):
``make_transport("host" | "fused", server)``; see ``transport/base.py``."""
from repro_torch.transport.base import (Transport, TransportStats,  # noqa: F401
                                        make_transport)
from repro_torch.transport.fused import (DeviceLoraView,  # noqa: F401
                                         FusedTransport, fused_hook_delta)
from repro_torch.transport.host import HostTransport  # noqa: F401

__all__ = ["Transport", "TransportStats", "make_transport", "HostTransport",
           "FusedTransport", "DeviceLoraView", "fused_hook_delta"]
