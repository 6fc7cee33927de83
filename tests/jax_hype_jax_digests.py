"""Compute the JAX package's digests that chip_smoke.py pins for the
padded-array engines.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_hype_jax_digests.py \
        [--port]

Runs, on the CPU, the JAX package's ``partition`` with ``hype_jax`` and
``hype_parallel`` on the graphs of ``HYPE_JAX_GRAPHS`` at seed 0, and
``hype_jax`` on the 6-vertex edge graph, for every key of
``HYPE_JAX_DIGESTS``, and prints each run's digest, k-1, part sizes and
seconds (first call, compilation included). With ``--port`` it runs the
same through the port (``repro_torch``) with ``device="cpu"`` and says
whether each equals JAX's. pl3000 costs JAX about 25 s; it is a helper,
not a test: pytest does not collect it.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def run(partition, synth, Hypergraph, metrics, **device):
    """Every pinned run through one package; key -> its values."""
    graphs = {name: synth.powerlaw_hypergraph(**kw)
              for name, kw in cs.HYPE_JAX_GRAPHS.items()}
    graphs["edges"] = Hypergraph.from_edge_lists(6, cs.HYPE_JAX_EDGES)
    out = {}
    for method, graph, k in cs.HYPE_JAX_DIGESTS:
        hg = graphs[graph]
        t0 = time.perf_counter()
        a = partition(hg, k, method, seed=0, **device)
        sizes = metrics.partition_sizes(a, k)
        out[f"{method}/{graph}/k{k}"] = {
            "digest": cs.digest(a),
            "k_minus_1": int(metrics.k_minus_1(hg, a, k)),
            "sizes": [int(sizes.min()), int(sizes.max())],
            "s": time.perf_counter() - t0}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU and compare")
    args = ap.parse_args()
    from repro.core import metrics
    from repro.core.hypergraph import Hypergraph
    from repro.core.partition_api import partition
    from repro.data import synthetic
    jax_out = run(partition, synthetic, Hypergraph, metrics)
    print(json.dumps({"jax": jax_out}), flush=True)
    if args.port:
        from repro_torch.core import metrics as t_metrics
        from repro_torch.core.hypergraph import Hypergraph as THypergraph
        from repro_torch.data import synthetic as t_synth
        from repro_torch.core.partition_api import partition as t_partition
        port = run(t_partition, t_synth, THypergraph, t_metrics,
                   device="cpu")
        print(json.dumps({"port": port}), flush=True)
        for key, want in jax_out.items():
            a = {k: v for k, v in want.items() if k != "s"}
            b = {k: v for k, v in port[key].items() if k != "s"}
            print(key, "equal" if a == b else f"DIFFER: {a} vs {b}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
