"""Rule registry of the port's checker: each rule module exports one Rule
class, keyed by its ``rule_id``."""
from repro_torch.staticcheck.rules.sc001_collectives import \
    NoCollectivesInServingPlane
from repro_torch.staticcheck.rules.sc002_capture_sync import \
    HostSyncInCapture
from repro_torch.staticcheck.rules.sc003_recapture import RecaptureHazard
from repro_torch.staticcheck.rules.sc004_kernels import KernelTwinDiscipline
from repro_torch.staticcheck.rules.sc005_retired_alias import \
    RetiredAliasRead
from repro_torch.staticcheck.rules.sc006_capture_transfer import \
    HostTransferInCapture
from repro_torch.staticcheck.rules.sc007_timing import \
    RawTimingInstrumentation

ALL_RULES = (
    NoCollectivesInServingPlane,
    HostSyncInCapture,
    RecaptureHazard,
    KernelTwinDiscipline,
    RetiredAliasRead,
    HostTransferInCapture,
    RawTimingInstrumentation,
)


def get_rules(select=None):
    """Instantiate the registered rules (optionally only ``select``, a
    collection of rule ids like {"SC001"})."""
    rules = [cls() for cls in ALL_RULES]
    if select:
        wanted = set(select)
        rules = [r for r in rules if r.rule_id in wanted]
    return rules
