"""The port stands alone: it imports neither JAX nor the JAX package.

Checked at run time (a fresh interpreter imports ``repro_torch`` and
runs every ported method on the CPU, then no ``jax`` and no ``repro``
module may be loaded) and statically (no import statement in ``src/repro_torch`` or
``chip_smoke.py`` names them, lazy imports inside functions included).
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]

_PROBE = """
import sys
from repro_torch.data.synthetic import powerlaw_hypergraph
from repro_torch.partition_api import partition
hg = powerlaw_hypergraph(200, 150, seed=2)
for method, kw in (("hype_superstep", {"pipeline_depth": 2}),
                   ("hype_batched", {"preset": "quality"}),
                   ("hype_multilevel", {}), ("multilevel", {})):
    a = partition(hg, 4, method, device="cpu", **kw)
    assert a.min() >= 0 and a.max() < 4, (method, a)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_runtime_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def _forbidden(path: pathlib.Path) -> list:
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    return bad


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_repro(path):
    assert _forbidden(path) == []


def test_static_scan_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from repro.core import metrics\n"
                     "    import jax.numpy\n")
    assert _forbidden(probe) == ["repro.core", "jax.numpy"]
