"""Hierarchical adapter store of the port (``repro.store``'s counterpart):
host/disk tiers under the device cache, async prefetch staging, and the
dynamic adapter lifecycle, and the sim plane's tensor-free twin
(``AnalyticStore``). Host tensors are CPU ``torch.Tensor``s."""
from repro_torch.store.convert import (host_tensor_bytes,
                                       host_tensors_from_pool,
                                       random_host_tensors,
                                       server_tensors_from_host,
                                       validate_host_tensors)
from repro_torch.store.prefetch import Prefetcher
from repro_torch.store.store import AdapterStore, AnalyticStore
from repro_torch.store.tensorfile import load as load_tensorfile
from repro_torch.store.tensorfile import save as save_tensorfile
from repro_torch.store.tiers import DiskTier, HostTier

__all__ = [
    "AdapterStore",
    "AnalyticStore",
    "DiskTier",
    "HostTier",
    "Prefetcher",
    "host_tensor_bytes",
    "host_tensors_from_pool",
    "load_tensorfile",
    "random_host_tensors",
    "save_tensorfile",
    "server_tensors_from_host",
    "validate_host_tensors",
]
