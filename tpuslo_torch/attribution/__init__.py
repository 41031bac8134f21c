"""L7 attribution engine: Bayesian + rule attribution, metrics, IO (the port's own copy of ``tpuslo/attribution/__init__.py``)."""

from tpuslo_torch.attribution.bayesian import (
    ALL_DOMAINS,
    SIGNAL_ELEVATION_THRESHOLDS,
    TPU_DOMAINS,
    BayesianAttributor,
    Posterior,
    default_likelihoods,
    default_priors,
)
from tpuslo_torch.attribution.io import (
    dump_attributions_jsonl,
    dump_samples_jsonl,
    load_samples_jsonl,
)
from tpuslo_torch.attribution.mapper import (
    FaultSample,
    build_attribution,
    expected_domains_for,
    map_fault_label,
)
from tpuslo_torch.attribution.pipeline import (
    MODE_BAYES,
    MODE_RULE,
    DomainScore,
    F1Report,
    accuracy,
    build_attributions,
    build_confusion_matrix,
    coverage_accuracy,
    macro_f1,
    normalize_mode,
    partial_accuracy,
)

__all__ = [
    "ALL_DOMAINS",
    "SIGNAL_ELEVATION_THRESHOLDS",
    "TPU_DOMAINS",
    "BayesianAttributor",
    "Posterior",
    "default_likelihoods",
    "default_priors",
    "dump_attributions_jsonl",
    "dump_samples_jsonl",
    "load_samples_jsonl",
    "FaultSample",
    "build_attribution",
    "expected_domains_for",
    "map_fault_label",
    "MODE_BAYES",
    "MODE_RULE",
    "DomainScore",
    "F1Report",
    "accuracy",
    "build_attributions",
    "build_confusion_matrix",
    "coverage_accuracy",
    "macro_f1",
    "normalize_mode",
    "partial_accuracy",
]
