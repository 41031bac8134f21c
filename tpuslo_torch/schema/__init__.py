"""L4 contract layer: canonical event types and contract validation (the
port's own copy of ``tpuslo/schema``; the validator is the port's own
checker, see :mod:`tpuslo_torch.schema.validator`)."""

from tpuslo_torch.schema.types import (
    ConnTuple,
    Evidence,
    FaultHypothesis,
    IncidentAttribution,
    ProbeEventV1,
    SLOEvent,
    SLOImpact,
    TPURef,
    parse_rfc3339,
    rfc3339,
)
from tpuslo_torch.schema.fastpath import (
    VALIDATION_COUNTERS,
    ValidationCounters,
    fast_probe_event_valid,
    fast_probe_payload_valid,
    validate_probe_event,
    validate_probe_payload,
)
from tpuslo_torch.schema.validator import (
    ALL_SCHEMAS,
    SCHEMA_INCIDENT_ATTRIBUTION,
    SCHEMA_PROBE_EVENT,
    SCHEMA_SLO_EVENT,
    SCHEMA_TOOLKIT_CONFIG,
    SchemaValidationError,
    is_valid,
    load_schema,
    schema_path,
    validate,
)

__all__ = [
    "ConnTuple",
    "Evidence",
    "FaultHypothesis",
    "IncidentAttribution",
    "ProbeEventV1",
    "SLOEvent",
    "SLOImpact",
    "TPURef",
    "parse_rfc3339",
    "rfc3339",
    "VALIDATION_COUNTERS",
    "ValidationCounters",
    "fast_probe_event_valid",
    "fast_probe_payload_valid",
    "validate_probe_event",
    "validate_probe_payload",
    "ALL_SCHEMAS",
    "SCHEMA_INCIDENT_ATTRIBUTION",
    "SCHEMA_PROBE_EVENT",
    "SCHEMA_SLO_EVENT",
    "SCHEMA_TOOLKIT_CONFIG",
    "SchemaValidationError",
    "is_valid",
    "load_schema",
    "schema_path",
    "validate",
]
