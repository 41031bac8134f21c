"""Device-plane accounting of the port: so far only the per-dispatch
ledger the serving front door keeps."""

from tpuslo_torch.deviceplane.dispatch import DispatchLedger

__all__ = ["DispatchLedger"]
