"""The port stands alone: it imports neither JAX nor the JAX package.

Checked at run time (a fresh interpreter imports ``repro_torch`` and
runs every ported method, the two-tower serving path, the serve
launcher for two-tower, dense and MoE LM serving, paged decode, the
flash-attention wrapper,
the HYPE row placement, the train launcher for GraphSAGE (neighbour
aggregation forward and backward, AdamW, checkpoints), for two-tower
(the EmbeddingBag backward, the loss) and for an MoE LM, gradient
compression, the sampler and
the partitioned-GNN placement on the CPU, then no ``jax`` and no
``repro`` module may be loaded) and statically (no import statement in ``src/repro_torch``,
``chip_smoke.py`` or ``kernel_ab.py`` names them, lazy imports inside
functions included). The port's modules mirror the JAX package's, the
entry point ``core/partition_api.py`` among them.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_ab.py"]

_PROBE = """
import sys
import numpy as np
import torch
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import powerlaw_hypergraph
from repro_torch.launch import serve
from repro_torch.models import recsys
from repro_torch.core.partition_api import METHODS, partition
from repro_torch.placement.partitioned_embedding import partition_rows_hype
hg = powerlaw_hypergraph(200, 150, seed=2)
knobs = {"hype_superstep": {"pipeline_depth": 2},
         "hype_batched": {"preset": "quality"}}
for method in METHODS:
    a = partition(hg, 4, method, device="cpu", **knobs.get(method, {}))
    assert a.min() >= 0 and a.max() < 4, (method, a)
cfg = get_arch("two-tower-retrieval").build_cfg(reduced=True)
params = recsys.init_twotower_params(torch.Generator().manual_seed(0), cfg)
ids = torch.zeros((2, cfg.n_fields, cfg.bag_size), dtype=torch.int32)
with torch.inference_mode():
    s = recsys.score_batch(params, {"user_ids": ids, "item_ids": ids}, cfg)
    v, i = recsys.retrieve(params, {"user_ids": ids[:1], "cand_embs":
                                    torch.ones(50, cfg.tower_dims[-1])}, cfg,
                           top_k=5)
assert s.shape == (2,) and i.tolist() == [0, 1, 2, 3, 4]
serve.main(["--arch", "two-tower-retrieval", "--reduced", "--device", "cpu"])
toks = serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt_len", "8", "--tokens", "2"])
assert toks.shape == (2, 3)
toks = serve.main(["--arch", "granite-moe-3b-a800m", "--reduced", "--device",
                   "cpu", "--batch", "2", "--prompt_len", "8", "--tokens",
                   "2"])
assert toks.shape == (2, 3)
from repro_torch.models import transformer as tf
mcfg = get_arch("mixtral-8x22b").build_cfg(reduced=True)
mp = tf.init_params(torch.Generator().manual_seed(0), mcfg)
with torch.inference_mode():
    mc, ml = tf.prefill(mp, torch.zeros((1, 20), dtype=torch.int32), mcfg)
    out = tf.serve_step_paged(mp, mc, torch.zeros((1, 1), dtype=torch.int32),
                              mcfg)
assert out[1].shape == (2, 1, 1, mcfg.n_kv_heads, mcfg.d_head)
from repro_torch.kernels.flash_attention import flash_attention
q = torch.ones((1, 8, 2, 16))
assert flash_attention(q, q[:, :, :1].contiguous(),
                       q[:, :, :1].contiguous()).shape == q.shape
a = partition_rows_hype(64, [[0, 1, 2], [2, 3], [5, 6, 7]], 2)
assert a.shape == (64,)
import tempfile
from repro_torch import convert
from repro_torch.data.graphs import NeighborSampler, random_graph
from repro_torch.launch import train
from repro_torch.placement.partitioned_gnn import (build_partitioned_graph,
                                                   graph_to_hypergraph)
with tempfile.TemporaryDirectory() as d:
    res = train.main(["--arch", "graphsage-reddit", "--reduced", "--steps",
                      "2", "--device", "cpu", "--ckpt_dir", d])
    assert res.steps_done == 2 and res.failures_recovered == 0
    res = train.main(["--arch", "two-tower-retrieval", "--reduced",
                      "--steps", "2", "--device", "cpu", "--ckpt_dir", d])
    assert res.steps_done == 2 and res.failures_recovered == 0
    for arch in ("mixtral-8x22b", "gatedgcn", "meshgraphnet", "schnet"):
        res = train.main(["--arch", arch, "--reduced", "--steps", "1",
                          "--device", "cpu", "--ckpt_dir", d])
        assert res.steps_done == 1 and res.failures_recovered == 0
from repro_torch.train.grad_compression import compress_tree
deq, err = compress_tree({"w": torch.ones(3)}, {"w": torch.zeros(3)})
src, dst = random_graph(50, 3.0, seed=0)
b = NeighborSampler(50, src, dst).sample_padded(
    np.arange(4), (3, 2), np.random.default_rng(0), 64, 64,
    np.zeros((50, 4), np.float32), np.zeros(50, np.int32))
pgr = build_partitioned_graph(50, src, dst, partition(
    graph_to_hypergraph(50, src, dst), 2, "hype", device="cpu"), 2)
assert pgr.s_max >= 0
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


# the JAX package's modules the port leaves out: the Pallas kernels (each
# became csrc/ beside its ops.py and ref.py), Pallas interpret mode, a
# deprecated shim, and the TPU compile-only tooling that needs repro.dist
NOT_PORTED = {"core/hype_batched.py", "kernels/_compat.py",
              "launch/dryrun.py", "launch/mesh.py",
              "launch/perf_experiments.py", "launch/roofline.py"}


def test_port_mirrors_the_jax_layout():
    """Every module of the JAX package has its namesake in the port,
    apart from NOT_PORTED and the kernel.py files; the entry point is
    core/partition_api.py, as in JAX, with nothing left at the root."""
    jax_mods = {str(p.relative_to(REPO / "src" / "repro"))
                for p in (REPO / "src" / "repro").rglob("*.py")}
    port = REPO / "src" / "repro_torch"
    missing = sorted(m for m in jax_mods - NOT_PORTED
                     if not m.endswith("/kernel.py")
                     and not (port / m).exists())
    assert missing == []
    assert (port / "core" / "partition_api.py").exists()
    assert not (port / "partition_api.py").exists()
    for kernel in (REPO / "src" / "repro" / "kernels").glob("*/kernel.py"):
        assert any((port / "kernels" / kernel.parent.name / "csrc").glob(
            "*.cu")), kernel.parent.name
