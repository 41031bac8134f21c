"""Signal names and statuses (the port's own copies of
``tpuslo/signals/constants.py`` and of ``signal_status``)."""

from tpuslo_torch.signals import constants
from tpuslo_torch.signals.generator import SIGNAL_THRESHOLDS, signal_status

__all__ = ["SIGNAL_THRESHOLDS", "constants", "signal_status"]
