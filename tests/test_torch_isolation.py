"""The PyTorch port stands alone: no JAX, and nothing of the JAX package.

Every module under ``src/repro_torch/`` and ``chip_smoke.py`` are scanned
for imports of ``jax`` / ``jaxlib`` / ``repro`` (``repro_torch`` is the
port itself), and a fresh interpreter importing the port must not pull
either in.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.core.aba, "
            "repro_torch.kernels.ops, repro_torch.data.synthetic, "
            "repro_torch.core.baselines, repro_torch.core.sharded, "
            "repro_torch.sharding, repro_torch.launch, repro_torch.train, "
            "repro_torch.serve, repro_torch.models, repro_torch.configs, "
            "repro_torch.models.transformer, repro_torch.models.layers, "
            "repro_torch.models.mamba, repro_torch.models.moe, "
            "repro_torch.models.mla, repro_torch.models.convert, "
            "repro_torch.serve.generate, repro_torch.kernels.ssm_scan, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.train.checkpoint, repro_torch.train.compression, "
            "repro_torch.launch.train, repro_torch.launch.dryrun, "
            "repro_torch.launch.cost, repro_torch.launch.inputs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
