"""Span sources of the port (the counterpart of ``tpuslo/otel``'s device
span source, :mod:`tpuslo_torch.otel.xla_spans`)."""
