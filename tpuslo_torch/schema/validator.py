"""Contract validation for every pipeline emit site (the port's
counterpart of ``tpuslo/schema/validator.py``).

The JAX package validates with the ``jsonschema`` package.  The port does
not depend on it: this module is a small checker of exactly the JSON
Schema keywords the contracts under ``contracts/`` use —

* ``type`` (one name or a list: object, array, string, integer, number,
  boolean, null; ``integer`` takes a float with an integral value, and
  ``bool`` is neither an integer nor a number, as in JSON Schema),
* ``properties``, ``required``, ``additionalProperties`` (``false`` or a
  schema),
* ``enum``, ``items``, ``minimum``, ``maximum``, ``minLength``,
* ``format: date-time`` (RFC 3339, checked here: a four-digit year other
  than 0, a valid month and day of that month, hours 00-23, minutes and
  seconds 00-59, optional fraction, ``Z`` or a ``±hh:mm`` offset; letters
  may be lower case),

and the annotations ``$schema``, ``$id``, ``title`` and ``description``.
A schema with any other keyword, or another ``format``, raises
:class:`UnsupportedSchemaError` when it is first loaded: a keyword this
checker does not know is never ignored.  Each keyword applies only to
values of its own type, as in JSON Schema.

Schemas are read once per process and cached; :func:`validate` raises
:class:`SchemaValidationError` with the full error list so emit sites can
fail loudly during tests and count drops in production.
"""

from __future__ import annotations

import calendar
import functools
import json
import numbers
import re
from pathlib import Path
from typing import Any

CONTRACTS_DIR = Path(__file__).resolve().parent / "contracts"

SCHEMA_SLO_EVENT = "v1/slo-event"
SCHEMA_INCIDENT_ATTRIBUTION = "v1/incident-attribution"
SCHEMA_PROBE_EVENT = "v1alpha1/probe-event"
SCHEMA_TOOLKIT_CONFIG = "v1alpha1/toolkit-config"

ALL_SCHEMAS = (
    SCHEMA_SLO_EVENT,
    SCHEMA_INCIDENT_ATTRIBUTION,
    SCHEMA_PROBE_EVENT,
    SCHEMA_TOOLKIT_CONFIG,
)

#: Keywords the checker applies, and annotations it reads past.
KEYWORDS = frozenset({
    "type", "properties", "required", "additionalProperties", "enum",
    "items", "minimum", "maximum", "minLength", "format",
})
ANNOTATIONS = frozenset({"$schema", "$id", "title", "description"})
FORMATS = frozenset({"date-time"})

_RFC3339 = re.compile(
    r"^(\d{4})-(0[1-9]|1[0-2])-(\d{2})T(?:[01]\d|2[0-3]):[0-5]\d:[0-5]\d"
    r"(?:\.\d+)?(?:Z|[+-](?:[01]\d|2[0-3]):[0-5]\d)$",
    re.ASCII,
)


class SchemaValidationError(ValueError):
    """Raised when a payload fails contract validation."""

    def __init__(self, schema_name: str, errors: list[str]):
        self.schema_name = schema_name
        self.errors = errors
        super().__init__(
            f"payload failed {schema_name} contract: " + "; ".join(errors[:5])
        )


class UnsupportedSchemaError(ValueError):
    """Raised for a schema that uses a keyword or format this checker
    does not implement."""


def schema_path(name: str) -> Path:
    """Resolve a short schema name like ``v1/slo-event`` to its file."""
    return CONTRACTS_DIR / f"{name}.schema.json"


def _check_schema(schema: Any, where: str) -> None:
    if not isinstance(schema, dict):
        raise UnsupportedSchemaError(f"{where}: a schema must be an object")
    unknown = set(schema) - KEYWORDS - ANNOTATIONS
    if unknown:
        raise UnsupportedSchemaError(f"{where}: unsupported keywords {sorted(unknown)}")
    if "format" in schema and schema["format"] not in FORMATS:
        raise UnsupportedSchemaError(f"{where}: unsupported format {schema['format']!r}")
    for name, sub in schema.get("properties", {}).items():
        _check_schema(sub, f"{where}/properties/{name}")
    extra = schema.get("additionalProperties", True)
    if not isinstance(extra, bool):
        _check_schema(extra, f"{where}/additionalProperties")
    if "items" in schema:
        _check_schema(schema["items"], f"{where}/items")


@functools.lru_cache(maxsize=None)
def load_schema(name: str) -> dict[str, Any]:
    schema = json.loads(schema_path(name).read_text())
    _check_schema(schema, name)
    return schema


def is_rfc3339(raw: str) -> bool:
    """An RFC 3339 date-time (see the module docstring for the rule)."""
    m = _RFC3339.match(raw.upper())
    if m is None:
        return False
    year, month, day = (int(g) for g in m.groups())
    return year != 0 and 1 <= day <= calendar.monthrange(year, month)[1]


def _is_number(value: Any) -> bool:
    return isinstance(value, numbers.Number) and not isinstance(value, bool)


def _is_type(value: Any, name: str) -> bool:
    if name == "object":
        return isinstance(value, dict)
    if name == "array":
        return isinstance(value, list)
    if name == "string":
        return isinstance(value, str)
    if name == "boolean":
        return isinstance(value, bool)
    if name == "null":
        return value is None
    if name == "number":
        return _is_number(value)
    if name == "integer":
        if isinstance(value, bool):
            return False
        return isinstance(value, int) or (isinstance(value, float) and value.is_integer())
    raise UnsupportedSchemaError(f"unknown type {name!r}")


def _equal(a: Any, b: Any) -> bool:
    """JSON equality: a boolean equals only a boolean."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    return a == b


def _errors(value: Any, schema: dict[str, Any], path: str, out: list[str]) -> None:
    where = path or "<root>"
    if "type" in schema:
        names = schema["type"] if isinstance(schema["type"], list) else [schema["type"]]
        if not any(_is_type(value, n) for n in names):
            out.append(f"{where}: {value!r} is not of type {', '.join(map(repr, names))}")
            return
    if "enum" in schema and not any(_equal(value, e) for e in schema["enum"]):
        out.append(f"{where}: {value!r} is not one of {schema['enum']!r}")
    if _is_number(value):
        if "minimum" in schema and value < schema["minimum"]:
            out.append(f"{where}: {value!r} is less than the minimum of {schema['minimum']!r}")
        if "maximum" in schema and value > schema["maximum"]:
            out.append(f"{where}: {value!r} is greater than the maximum of {schema['maximum']!r}")
    if isinstance(value, str):
        if "minLength" in schema and len(value) < schema["minLength"]:
            out.append(f"{where}: {value!r} is shorter than {schema['minLength']}")
        if schema.get("format") == "date-time" and not is_rfc3339(value):
            out.append(f"{where}: {value!r} is not a 'date-time'")
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            _errors(item, schema["items"], f"{path}/{i}" if path else str(i), out)
    if isinstance(value, dict):
        props = schema.get("properties", {})
        for key in schema.get("required", ()):
            if key not in value:
                out.append(f"{where}: {key!r} is a required property")
        extra = schema.get("additionalProperties", True)
        for key, item in value.items():
            sub = f"{path}/{key}" if path else str(key)
            if key in props:
                _errors(item, props[key], sub, out)
            elif extra is False:
                out.append(f"{where}: additional property {key!r} is not allowed")
            elif isinstance(extra, dict):
                _errors(item, extra, sub, out)


def errors(payload: Any, schema_name: str) -> list[str]:
    """Every contract violation of ``payload``, sorted (empty: valid)."""
    out: list[str] = []
    _errors(payload, load_schema(schema_name), "", out)
    return sorted(out)


def validate(payload: dict[str, Any], schema_name: str) -> None:
    """Validate one payload dict against a named contract.

    Raises :class:`SchemaValidationError` on the first batch of failures.
    """
    found = errors(payload, schema_name)
    if found:
        raise SchemaValidationError(schema_name, found)


def is_valid(payload: dict[str, Any], schema_name: str) -> bool:
    """Non-raising variant used by drop accounting in hot loops."""
    return not errors(payload, schema_name)
