"""Span processors of the port (its copy of ``tpuslo/otel/processor``)."""
