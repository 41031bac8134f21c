"""Self-observability of the port: so far only the null tracer cycle the
untraced serving step runs under."""
