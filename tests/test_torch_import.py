"""The PyTorch port stands alone: no JAX, nothing of ``repro``, no ``ml_dtypes``.

Every module of ``repro_torch`` must import in a process where ``jax``,
``repro`` and ``ml_dtypes`` cannot be imported, and no source file of the
port (nor ``chip_smoke.py``) may name any of them in an import statement.
"""

import ast
import os
import subprocess
import sys

from helpers import REPO_SRC

_ROOT = os.path.abspath(os.path.join(REPO_SRC, ".."))
_PORT = os.path.join(os.path.abspath(REPO_SRC), "repro_torch")

_IMPORT_ALL = """
import importlib, os, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
root = os.path.join(sys.argv[1], "repro_torch")
names = []
for dirpath, _dirs, files in os.walk(root):
    pkg = os.path.relpath(dirpath, sys.argv[1]).replace(os.sep, ".")
    for f in sorted(files):
        if f.endswith(".py"):
            names.append(pkg if f == "__init__.py" else f"{pkg}.{f[:-3]}")
for name in sorted(names):
    importlib.import_module(name)
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m]}
assert not loaded & {"jax", "repro", "ml_dtypes"}, loaded
print(" ".join(sorted(names)))
print("OK", len(names))
"""


def _port_sources() -> list:
    out = []
    for dirpath, _dirs, files in os.walk(_PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(_ROOT, "chip_smoke.py")]


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO_SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, os.path.abspath(REPO_SRC)],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    n = int(proc.stdout.split()[-1])
    assert n >= 87, proc.stdout
    imported = set(proc.stdout.split())
    for name in (
        "repro_torch.kernels.ssd_scan",
        "repro_torch.models.mamba",
        "repro_torch.kernels.mlstm_scan",
        "repro_torch.models.xlstm",
        "repro_torch.apps.amg",
        "repro_torch.apps.laghos",
        "repro_torch.apps.beatnik",
        "repro_torch.core.network",
        "repro_torch.core.reports",
        "repro_torch.core.streaming",
        "repro_torch.benchpark.spec",
        "repro_torch.benchpark.runner",
        "repro_torch.benchpark.aggregator",
        "repro_torch.ckpt.manager",
        "repro_torch.figures.paper_data",
        "repro_torch.figures.fig8_halo_heatmap",
        "repro_torch.figures.run",
        "repro_torch.examples.quickstart",
        "repro_torch.examples.profile_comm_patterns",
        "repro_torch.core.ranks",
        "repro_torch.apps.multirank",
        "repro_torch.figures.fig7_hlo_vs_traced",
        "repro_torch.models.moe",
        "repro_torch.models.encdec",
        "repro_torch.kernels.flash_attention_bwd",
        "repro_torch.optim.adamw",
        "repro_torch.optim.compress",
        "repro_torch.train.steps",
        "repro_torch.data.pipeline",
        "repro_torch.launch.train",
        "repro_torch.examples.train_lm",
        "repro_torch.kernels.ssd_scan_bwd",
        "repro_torch.kernels.mlstm_scan_bwd",
        "repro_torch.parallel",
        "repro_torch.parallel.sharding",
        "repro_torch.parallel.context",
        "repro_torch.parallel.pipeline",
        "repro_torch.launch.mesh",
        "repro_torch.core.hlo_cost",
        "repro_torch.launch.dryrun",
        "repro_torch.figures.roofline",
        "repro_torch.figures.inspect_cell",
    ):
        assert name in imported, proc.stdout


def test_no_source_imports_jax_or_repro():
    banned = {"jax", "jaxlib", "repro", "ml_dtypes"}
    offenders = []
    sources = _port_sources()
    assert len(sources) >= 88
    names = {os.path.relpath(p, _ROOT) for p in sources}
    assert {
        "src/repro_torch/kernels/mlstm_scan.py",
        "src/repro_torch/models/xlstm.py",
        "src/repro_torch/apps/amg.py",
        "src/repro_torch/apps/laghos.py",
        "src/repro_torch/apps/beatnik.py",
        "src/repro_torch/core/network.py",
        "src/repro_torch/core/reports.py",
        "src/repro_torch/core/streaming.py",
        "src/repro_torch/benchpark/spec.py",
        "src/repro_torch/benchpark/runner.py",
        "src/repro_torch/benchpark/aggregator.py",
        "src/repro_torch/ckpt/manager.py",
        "src/repro_torch/figures/run.py",
        "src/repro_torch/examples/quickstart.py",
        "src/repro_torch/core/ranks.py",
        "src/repro_torch/apps/multirank.py",
        "src/repro_torch/figures/fig7_hlo_vs_traced.py",
        "src/repro_torch/models/moe.py",
        "src/repro_torch/models/encdec.py",
        "src/repro_torch/kernels/flash_attention_bwd.py",
        "src/repro_torch/optim/adamw.py",
        "src/repro_torch/optim/compress.py",
        "src/repro_torch/train/steps.py",
        "src/repro_torch/data/pipeline.py",
        "src/repro_torch/launch/train.py",
        "src/repro_torch/examples/train_lm.py",
        "src/repro_torch/kernels/ssd_scan_bwd.py",
        "src/repro_torch/kernels/mlstm_scan_bwd.py",
        "src/repro_torch/parallel/sharding.py",
        "src/repro_torch/parallel/context.py",
        "src/repro_torch/parallel/pipeline.py",
        "src/repro_torch/launch/mesh.py",
        "src/repro_torch/core/hlo_cost.py",
        "src/repro_torch/launch/dryrun.py",
        "src/repro_torch/figures/roofline.py",
        "src/repro_torch/figures/inspect_cell.py",
    } <= names
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path}:{node.lineno}: {name}")
    assert not offenders, "\n".join(offenders)
