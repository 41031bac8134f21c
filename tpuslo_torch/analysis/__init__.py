"""The port's counterpart of ``tpuslo/analysis``: only the dynamic
capture and host-sync audit the serving benches gate on
(:mod:`tpuslo_torch.analysis.jitaudit`)."""
