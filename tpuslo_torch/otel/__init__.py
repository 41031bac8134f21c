"""Span sources and exporters of the port (the counterparts of
``tpuslo/otel``'s device span source, :mod:`tpuslo_torch.otel.xla_spans`,
and its OTLP/HTTP log exporters, :mod:`tpuslo_torch.otel.exporters`)."""
