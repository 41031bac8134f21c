"""Attribution batch pipeline + accuracy metrics
(the port's own copy of ``tpuslo/attribution/pipeline.py``; its
chaos-sweep evaluation needs the ingest gate and the chaos stream, which
the port does not have yet, and is not ported).

Reference: ``pkg/attribution/pipeline.go`` — mode dispatch (bayes|rule),
confusion matrix, exact / partial / coverage accuracy.  The TPU-native
build adds per-domain precision/recall/F1 and macro-F1, since the
rebuild's headline target is attribution F1 ≥ 0.70 on injected TPU
faults (BASELINE.md).
"""

from __future__ import annotations

from dataclasses import dataclass

from tpuslo_torch.attribution.bayesian import DOMAIN_UNKNOWN, BayesianAttributor
from tpuslo_torch.attribution.mapper import (
    FaultSample,
    build_attribution,
    expected_domains_for,
    map_fault_label,
)
from tpuslo_torch.schema import IncidentAttribution

MODE_BAYES = "bayes"
MODE_RULE = "rule"


def normalize_mode(mode: str) -> str:
    mode = (mode or "").strip().lower()
    return MODE_RULE if mode == MODE_RULE else MODE_BAYES


def build_attributions(
    samples: list[FaultSample],
    mode: str = MODE_BAYES,
    attributor: BayesianAttributor | None = None,
) -> list[IncidentAttribution]:
    """Attribute a batch of samples under the requested mode."""
    if normalize_mode(mode) == MODE_RULE:
        return [build_attribution(s) for s in samples]
    attributor = attributor or BayesianAttributor()
    # Vectorized path; parity with per-sample attribute_sample is
    # covered by tests/test_attribution.py::TestBatchParity.
    return attributor.attribute_batch(samples)


def _actual_domain(sample: FaultSample) -> str:
    return sample.expected_domain or map_fault_label(sample.fault_label)


def build_confusion_matrix(
    samples: list[FaultSample], predictions: list[IncidentAttribution]
) -> dict[tuple[str, str], int]:
    """Counts keyed by (actual, predicted) fault domain."""
    matrix: dict[tuple[str, str], int] = {}
    for sample, prediction in zip(samples, predictions):
        key = (_actual_domain(sample), prediction.predicted_fault_domain)
        matrix[key] = matrix.get(key, 0) + 1
    return matrix


def accuracy(
    samples: list[FaultSample], predictions: list[IncidentAttribution]
) -> float:
    """Exact top-1 accuracy against the primary expected domain."""
    if not predictions:
        return 0.0
    correct = sum(
        1
        for sample, prediction in zip(samples, predictions)
        if _actual_domain(sample) == prediction.predicted_fault_domain
    )
    return correct / len(predictions)


def partial_accuracy(
    samples: list[FaultSample], predictions: list[IncidentAttribution]
) -> float:
    """Top-1 ∈ expected_domains (partial credit on multi-fault samples)."""
    if not predictions:
        return 0.0
    correct = sum(
        1
        for sample, prediction in zip(samples, predictions)
        if prediction.predicted_fault_domain in expected_domains_for(sample)
    )
    return correct / len(predictions)


def coverage_accuracy(
    samples: list[FaultSample],
    predictions: list[IncidentAttribution],
    threshold: float = 0.05,
) -> float:
    """Mean fraction of expected domains present in hypotheses ≥ threshold."""
    if not predictions:
        return 0.0
    total = 0.0
    for sample, prediction in zip(samples, predictions):
        expected = expected_domains_for(sample)
        covered = {
            h.domain
            for h in prediction.fault_hypotheses
            if h.posterior >= threshold
        }
        covered.add(prediction.predicted_fault_domain)
        total += sum(1 for d in expected if d in covered) / len(expected)
    return total / len(predictions)


@dataclass
class DomainScore:
    domain: str
    precision: float
    recall: float
    f1: float
    support: int


@dataclass
class F1Report:
    per_domain: list[DomainScore]
    macro_f1: float
    micro_accuracy: float


def macro_f1(
    samples: list[FaultSample],
    predictions: list[IncidentAttribution],
    domains: list[str] | None = None,
) -> F1Report:
    """Per-domain precision/recall/F1 plus macro-F1.

    Macro-F1 averages over domains with support (ground truth present)
    or predictions — unpredicted, absent domains don't dilute the mean.
    Multi-fault samples credit a true positive when the top-1 prediction
    matches any expected domain; the primary expected domain carries the
    support count.

    An ``unknown`` prediction on a faulted sample is an ABSTENTION, not
    a fault claim: it costs the true class a false negative (recall
    drops) but does not manufacture an ``unknown`` false-positive class
    — abstention frequency is scored by the separately published
    abstain rate (``calibrate.heldout_report``), not as a stray class.
    ``unknown`` still enters the macro when it has support (no-fault
    samples), where false alarms hurt its recall.
    """
    tp: dict[str, int] = {}
    fp: dict[str, int] = {}
    fn: dict[str, int] = {}
    support: dict[str, int] = {}
    correct = 0

    for sample, prediction in zip(samples, predictions):
        expected = expected_domains_for(sample)
        primary = expected[0]
        predicted = prediction.predicted_fault_domain
        support[primary] = support.get(primary, 0) + 1
        if predicted in expected:
            tp[predicted] = tp.get(predicted, 0) + 1
            correct += 1
        else:
            if predicted != DOMAIN_UNKNOWN:
                fp[predicted] = fp.get(predicted, 0) + 1
            fn[primary] = fn.get(primary, 0) + 1

    if domains is None:
        domains = sorted(set(support) | set(tp) | set(fp))

    scores = []
    for domain in domains:
        d_tp = tp.get(domain, 0)
        d_fp = fp.get(domain, 0)
        d_fn = fn.get(domain, 0)
        precision = d_tp / (d_tp + d_fp) if d_tp + d_fp else 0.0
        recall = d_tp / (d_tp + d_fn) if d_tp + d_fn else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall
            else 0.0
        )
        scores.append(
            DomainScore(domain, precision, recall, f1, support.get(domain, 0))
        )

    macro = sum(s.f1 for s in scores) / len(scores) if scores else 0.0
    micro = correct / len(predictions) if predictions else 0.0
    return F1Report(per_domain=scores, macro_f1=macro, micro_accuracy=micro)
