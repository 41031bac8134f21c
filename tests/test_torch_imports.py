"""The port stands alone: nothing in ``tpuslo_torch/`` or ``chip_smoke.py``
imports JAX, the JAX package (``tpuslo``) or its demo (``demo``),
statically or at run time, nor ``jsonschema`` or ``yaml`` (the card's
machine has neither; the port's contract validator is its own, its probe
manifest is JSON)."""

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
    return root in ("jax", "jaxlib", "tpuslo", "demo", "jsonschema", "yaml")


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
                "models/trainer.py", "cli/train.py", "parallel/collectives.py",
                "parallel/distributed.py", "correlation/multihost.py",
                "faultreplay/slice_streams.py", "cli/icibench.py", "cli/slicecorr.py",
                "chaos/__init__.py", "chaos/backend_guard.py", "chaos/ici_contention.py",
                "chaos/injectors/ici_contention.py", "chaos/injectors/hbm_pressure.py",
                "chaos/injectors/xla_recompile_storm.py", "otel/processor/correlator.py",
                "slo/calculator.py", "demo/common.py", "demo/vectordb/store.py",
                "demo/vectordb/server.py", "demo/rag_service/service.py",
                "demo/rag_service/server.py", "cli/agent.py", "cli/common.py",
                "config/__init__.py", "config/toolkitcfg.py", "config/yamlsubset.py",
                "delivery/__init__.py", "delivery/options.py", "delivery/breaker.py",
                "delivery/spool.py", "delivery/channel.py", "delivery/sinks.py",
                "delivery/faultsink.py", "webhook/__init__.py", "webhook/exporter.py",
                "webhook/pagerduty.py", "webhook/opsgenie.py", "metrics/registry.py",
                "otel/exporters.py", "obs/export.py", "collector/kernel.py",
                "collector/pipeline.py", "collector/hello_tracer.py",
                "demo/e2e_onchip_session.py"):
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
        "tpuslo_torch.cli.train, tpuslo_torch.parallel.collectives, "
        "tpuslo_torch.parallel.distributed, tpuslo_torch.correlation.multihost, "
        "tpuslo_torch.faultreplay.slice_streams, tpuslo_torch.cli.icibench, "
        "tpuslo_torch.cli.slicecorr, tpuslo_torch.chaos.backend_guard, "
        "tpuslo_torch.chaos.ici_contention, tpuslo_torch.chaos.injectors.ici_contention, "
        "tpuslo_torch.chaos.injectors.hbm_pressure, "
        "tpuslo_torch.chaos.injectors.xla_recompile_storm, "
        "tpuslo_torch.otel.processor.correlator, tpuslo_torch.slo, "
        "tpuslo_torch.demo.vectordb.server, tpuslo_torch.demo.rag_service.server, "
        "tpuslo_torch.cli.agent, tpuslo_torch.cli.common, tpuslo_torch.config, "
        "tpuslo_torch.config.yamlsubset, tpuslo_torch.delivery, "
        "tpuslo_torch.delivery.sinks, tpuslo_torch.delivery.faultsink, "
        "tpuslo_torch.webhook, tpuslo_torch.metrics.registry, "
        "tpuslo_torch.otel.exporters, tpuslo_torch.obs.export, "
        "tpuslo_torch.collector.kernel, tpuslo_torch.collector.pipeline, "
        "tpuslo_torch.collector.hello_tracer, tpuslo_torch.demo.e2e_onchip_session; "
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'tpuslo', 'demo', 'jsonschema', 'yaml')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_spawned_workers_load_no_jax():
    """The processes the port starts (``python -m
    tpuslo_torch.parallel.distributed`` workers, ``run_ranks`` ranks) run
    port code alone: a worker's whole run, and a rank's imports, load no
    JAX and no JAX package."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['distributed', '--process-id', '0', '--num-processes', '1', "
        "'--port', str(__import__('tpuslo_torch.parallel.distributed', fromlist=['x'])"
        "._free_port()), '--launches', '1', '--payload-kb', '4']\n"
        "import tpuslo_torch.parallel.mesh, tpuslo_torch.cli.icibench\n"
        "try:\n"
        "    runpy.run_module('tpuslo_torch.parallel.distributed', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuslo'))\n"
        "print(bad, file=sys.stderr); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"signal": "ici_collective_latency_ms"' in proc.stdout


def test_straggler_host_worker_loads_no_jax():
    """A straggler host process (``python -m tpuslo_torch.chaos.ici_contention
    --worker``) runs port code alone."""
    code = (
        "import runpy, socket, sys, threading\n"
        "from tpuslo_torch.chaos import ici_contention as ic\n"
        "server = socket.socket(); server.bind(('127.0.0.1', 0)); server.listen(1)\n"
        "t = threading.Thread(target=ic._barrier_coordinator, args=(server, 1, 1))\n"
        "t.start()\n"
        "sys.argv = ['ici_contention', '--worker', '--port', str(server.getsockname()[1]), "
        "'--host-index', '0', '--launches', '1', '--delay-ms', '0', '--delayed-host', '-1']\n"
        "try:\n"
        "    runpy.run_module('tpuslo_torch.chaos.ici_contention', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "t.join(30)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpuslo', 'demo'))\n"
        "print(bad, file=sys.stderr); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"signal": "ici_collective_latency_ms"' in proc.stdout
