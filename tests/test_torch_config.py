"""The port's toolkit config: its YAML reader
(``tpuslo_torch.config.yamlsubset``, the card's machine has no PyYAML)
equals ``yaml.safe_load`` on every ``config/*.yaml`` and on the YAML the
JAX package's agent and config tests write, raises ``ValueError`` naming
the line on anything outside its subset, and the port's ``load_config``
equals the JAX package's field by field."""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from tpuslo.config import default_config as jdefault_config
from tpuslo.config import load_config as jload_config
from tpuslo_torch.config import default_config, load_config
from tpuslo_torch.config.yamlsubset import safe_load

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = sorted((ROOT / "config").glob("*.yaml"))

# What the JAX package's config, remediation, chaos and agent tests write.
WRITTEN = {
    "slo_overrides": """
apiVersion: toolkit.tpuslo.dev/v1alpha1
kind: ToolkitConfig
signal_set: [dns_latency_ms, xla_compile_ms]
sampling:
  events_per_second_limit: 500
  burst_limit: 0
correlation:
  window_ms: 1000
safety:
  max_overhead_pct: 2.5
webhook:
  enabled: true
  url: http://hooks.example/incident
  format: pagerduty
tpu:
  slice_id: v5e-8-s0
""",
    "slo_tenants": """
slo:
  availability_target: 0.995
  ttft_objective_ms: 600
  tenants:
    gold:
      availability_target: 0.999
      ttft_objective_ms: 400
""",
    "slo_disabled": "slo:\n  enabled: false\n",
    "window": "correlation:\n  window_ms: 1500\n",
    "remediation": (
        "signal_set: [dns_latency_ms]\n"
        "sampling: {events_per_second_limit: 100}\n"
        "correlation: {window_ms: 1000}\n"
        "otlp: {endpoint: http://x/v1/logs}\n"
        "safety: {max_overhead_pct: 3.0}\n"
        "remediation:\n"
        "  min_confidence: 0.9\n"
        "  disabled_actions: [cordon_node]\n"
        "  enabled: false\n"
    ),
    "chaos_delivery": """\
apiVersion: toolkit.tpuslo.dev/v1alpha1
kind: ToolkitConfig
signal_set: [dns_latency_ms, tcp_retransmits_total]
sampling: {events_per_second_limit: 10000, burst_limit: 20000}
correlation: {window_ms: 2000, enrichment_threshold: 0.7}
otlp: {endpoint: "http://unused-placeholder:4318/v1/logs"}
safety: {max_overhead_pct: 1000.0}
delivery:
  queue_max: 64
  max_attempts: 2
  base_delay_s: 0.005
  max_delay_s: 0.02
  breaker_failure_threshold: 3
  breaker_open_duration_s: 0.1
""",
    "scalars": (
        "ints: [0, -3, +7, 1_000, 0x1F, 0o17, 017, 0b101]\n"
        "floats: [1.5, -2., .5, 1.0e+3, 6.02E-23, .inf, -.Inf, 1e5]\n"
        "bools: [yes, No, TRUE, off, On, y, n]\n"
        "nulls: [~, null, NULL]\n"
        "empty:\n"
        "quoted: ['it''s', \"tab\\there\", \"\\u00e9\\x41\", '# not a comment']\n"
        "url: http://a.example:8080/x#frag  # a comment\n"
        "'quoted key': 1\n"
        "\"2\": two\n"
        "3: three\n"
    ),
    "nested": (
        "top:\n"
        "- a\n"
        "- k: v\n"
        "  k2: [1, {x: y}]\n"
        "- - n1\n"
        "  - n2\n"
        "-\n"
        "- {}\n"
        "- []\n"
        "under:\n"
        "  deep:\n"
        "    deeper: 1\n"
        "  # a comment line\n"
        "  back: 2\n"
    ),
    "list": "- a\n- b\n",
    "empty": "",
    "comments_only": "# nothing\n\n   # more\n",
}

UNSUPPORTED = {
    "anchor": "a: &x 1\n",
    "alias": "a: 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "block_scalar": "a: |\n  text\n",
    "folded_scalar": "a: >\n  text\n",
    "multiline_flow": "a: [1,\n  2]\n",
    "continued_plain": "a: one\n  two\n",
    "document_marker": "---\na: 1\n",
    "timestamp": "a: 2001-12-14\n",
    "sexagesimal": "a: 1:30\n",
    "complex_key": "? a\n: b\n",
    "inline_mapping": "a: b: c\n",
    "tab_indent": "a:\n\t- 1\n",
    "merge_key": "a: {x: 1}\n<<: 2\n",
    "bad_indent": "a: 1\n   b: 2\n",
}


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: p.name)
def test_reader_equals_safe_load_on_the_shipped_configs(path):
    text = path.read_text()
    assert _same(safe_load(text), yaml.safe_load(text))
    with open(path, encoding="utf-8") as fh:
        assert _same(safe_load(fh), yaml.safe_load(text))


@pytest.mark.parametrize("name", sorted(WRITTEN))
def test_reader_equals_safe_load_on_written_yaml(name):
    text = WRITTEN[name]
    assert _same(safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_syntax_raises_naming_the_line(name):
    with pytest.raises(ValueError, match=r"^line \d+: .* outside the YAML subset"):
        safe_load(UNSUPPORTED[name])


def _both(path: str):
    port = load_config(path)
    return dataclasses.asdict(port), dataclasses.asdict(jload_config(path))


@pytest.mark.parametrize("path", [p for p in SHIPPED if p.name != "libtpu-symbols.yaml"],
                         ids=lambda p: p.name)
def test_load_config_equals_jax_on_the_shipped_configs(path):
    port, jax_cfg = _both(str(path))
    assert port == jax_cfg


@pytest.mark.parametrize("name", ["slo_overrides", "slo_tenants", "slo_disabled", "window",
                                  "remediation", "chaos_delivery"])
def test_load_config_equals_jax_on_written_configs(name, tmp_path):
    path = tmp_path / "toolkit.yaml"
    path.write_text(WRITTEN[name])
    port, jax_cfg = _both(str(path))
    assert port == jax_cfg


def test_default_config_equals_jax():
    assert dataclasses.asdict(default_config()) == dataclasses.asdict(jdefault_config())


@pytest.mark.parametrize("text, error", [
    ("- a\n- b\n", ValueError),
    ("correlation:\n  window_ms: -5\n", Exception),
    ("slo:\n  tenants:\n    gold:\n      availability_target: not-a-number\n", Exception),
    ("remediation: {disabled_actions: [typo]}\n", ValueError),
    ("a: &anchor 1\n", ValueError),
], ids=["non_mapping", "bad_schema", "bad_tenant", "unknown_action", "outside_subset"])
def test_load_config_rejects_what_jax_rejects(text, error, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(error):
        load_config(str(path))
    if "anchor" not in text:
        with pytest.raises(error):
            jload_config(str(path))
