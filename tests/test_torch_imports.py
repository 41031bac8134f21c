"""The port stands alone: nothing in ``tpuslo_torch/`` or ``chip_smoke.py``
imports JAX or the JAX package (``tpuslo``), statically or at run time,
nor ``jsonschema`` or ``yaml`` (the card's machine has neither; the
port's contract validator is its own, its probe manifest is JSON)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "tpuslo_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "tpuslo", "jsonschema", "yaml")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield node.lineno, arg.value


def test_port_files_exist():
    assert len(PORT_FILES) >= 10
    assert REPO / "tpuslo_torch" / "models" / "serve.py" in PORT_FILES
    for rel in ("models/speculative.py", "models/frontdoor.py", "models/router.py",
                "sloengine/engine.py", "deviceplane/dispatch.py", "obs/tracer.py",
                "otel/xla_spans.py", "signals/constants.py", "signals/generator.py",
                "deviceplane/ledger.py", "deviceplane/synthetic.py",
                "deviceplane/roofline.py", "deviceplane/profiler.py",
                "collector/hbm_sampler.py", "collector/native.py",
                "collector/ringbuf.py", "collector/synthetic.py",
                "schema/types.py", "schema/validator.py", "schema/fastpath.py",
                "signals/metadata.py", "signals/mode.py", "attribution/mapper.py",
                "attribution/bayesian.py", "attribution/pipeline.py",
                "attribution/io.py", "attribution/calibrate.py",
                "columnar/posterior.py", "faultreplay/generator.py",
                "analysis/jitaudit.py", "benchmark/frontdoor_bench.py",
                "benchmark/router_bench.py", "cli/loadgen.py", "benchmark/probes.py",
                "ops/dense_lanes.py", "ops/rms_norm.py", "ops/launch_counts.py",
                "semconv/__init__.py", "metrics/rejections.py", "metrics/__init__.py",
                "correlation/matcher.py", "correlation/__init__.py", "sloengine/sweep.py",
                "benchmark/serving_bench.py", "ops/moe.py", "models/mixtral.py",
                "collector/symbols.py", "collector/probe_manager.py", "prereq/checker.py",
                "prereq/__init__.py", "parallel/__init__.py", "parallel/mesh.py",
                "models/data.py", "models/train.py", "models/checkpoint.py",
                "models/trainer.py", "cli/train.py"):
        assert REPO / "tpuslo_torch" / rel in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_tpuslo_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, tpuslo_torch.models, tpuslo_torch.ops, tpuslo_torch.models.bridge, "
        "tpuslo_torch.models.frontdoor, tpuslo_torch.models.router, "
        "tpuslo_torch.models.speculative, tpuslo_torch.sloengine, "
        "tpuslo_torch.deviceplane, tpuslo_torch.obs.tracer, tpuslo_torch.obs, "
        "tpuslo_torch.otel.xla_spans, tpuslo_torch.signals, "
        "tpuslo_torch.collector.hbm_sampler, tpuslo_torch.collector.ringbuf, "
        "tpuslo_torch.deviceplane.profiler, tpuslo_torch.schema, "
        "tpuslo_torch.attribution, tpuslo_torch.attribution.calibrate, "
        "tpuslo_torch.columnar, tpuslo_torch.faultreplay, tpuslo_torch.signals.mode, "
        "tpuslo_torch.analysis.jitaudit, tpuslo_torch.benchmark.frontdoor_bench, "
        "tpuslo_torch.benchmark.router_bench, tpuslo_torch.cli.loadgen, "
        "tpuslo_torch.benchmark.probes, tpuslo_torch.ops.rms_norm, tpuslo_torch.semconv, "
        "tpuslo_torch.metrics, tpuslo_torch.correlation, tpuslo_torch.sloengine.sweep, "
        "tpuslo_torch.benchmark.serving_bench, tpuslo_torch.ops.moe, "
        "tpuslo_torch.models.mixtral, tpuslo_torch.collector, "
        "tpuslo_torch.collector.symbols, tpuslo_torch.collector.probe_manager, "
        "tpuslo_torch.prereq, tpuslo_torch.prereq.checker, tpuslo_torch.parallel.mesh, "
        "tpuslo_torch.models.data, tpuslo_torch.models.train, "
        "tpuslo_torch.models.checkpoint, tpuslo_torch.models.trainer, "
        "tpuslo_torch.cli.train; "
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'tpuslo', 'jsonschema', 'yaml')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
