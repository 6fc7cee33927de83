"""Compute the JAX package's stream digests that chip_smoke.py pins.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_stream_digests.py \
        [--port]

Runs, on the CPU, the JAX package's ``hype_stream_partition`` on
``github_like(1.0, seed=0)`` at k=32 with ``StreamParams(seed=0)``:

  * ``STREAM_DIGEST``, ``STREAM_KM1``, ``STREAM_BATCHES`` and
    ``STREAM_PLANNED``: the clean pass (plan (64, 2048));
  * ``STREAM_BUDGET_PLAN`` and ``STREAM_BUDGET_DIGEST``: the pass at
    ``mem_budget=STREAM_BUDGET``;
  * ``STREAM_UPDATE_DIGEST``: ``apply_updates`` of chip_smoke's
    ``stream_ops(state, seed=0)`` on the clean pass's state, the digest
    of ``state.assignment`` (-1 where a vertex was removed).

With ``--port`` it runs the same three through the port (``repro_torch``)
with ``device="cpu"`` and prints its values beside JAX's. JAX takes about
three minutes, the port about as long. It is a helper, not a test: pytest
does not collect it.
"""
import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def run(mod_stream, synth, metrics, **device):
    """The three runs through one package; returns a dict of values."""
    out = {}
    hg = synth.github_like(1.0, seed=0)
    t0 = time.perf_counter()
    a, state = mod_stream.hype_stream_partition(
        hg, 32, mod_stream.StreamParams(seed=0), return_state=True, **device)
    st = state.stats
    sizes = metrics.partition_sizes(a, 32)
    out["clean"] = {
        "fingerprint": hg.fingerprint(), "n": hg.n, "digest": cs.digest(a),
        "k_minus_1": int(metrics.k_minus_1(hg, a, 32)),
        "sizes": [int(sizes.min()), int(sizes.max())],
        "micro_batches": st.micro_batches, "planned_bytes": st.planned_bytes,
        "plan": [st.plan_micro_batch, st.plan_tile_l],
        "sketch_digest": state.sketch_digest(),
        "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ops = cs.stream_ops(state, seed=0)
    mod_stream.apply_updates(state, ops)
    st = state.stats
    out["update"] = {
        "ops": len(ops), "digest": cs.digest(state.assignment),
        "sketch_digest": state.sketch_digest(),
        "inserts": st.inserts, "deletes": st.deletes,
        "readmitted": st.readmitted, "refine_moves": st.refine_moves,
        "rebalance_moves": st.rebalance_moves,
        "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    p = dataclasses.replace(mod_stream.StreamParams(seed=0),
                            mem_budget=cs.STREAM_BUDGET)
    a, st = mod_stream.hype_stream_partition(hg, 32, p, return_stats=True,
                                             **device)
    out["budget"] = {
        "digest": cs.digest(a),
        "plan": [st.plan_micro_batch, st.plan_tile_l, st.planned_bytes,
                 st.micro_batches],
        "s": time.perf_counter() - t0}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU and compare")
    args = ap.parse_args()
    from repro.core import hype_stream, metrics
    from repro.data import synthetic
    jax_out = run(hype_stream, synthetic, metrics)
    print(json.dumps({"jax": jax_out}), flush=True)
    if args.port:
        from repro_torch.core import hype_stream as t_stream
        from repro_torch.core import metrics as t_metrics
        from repro_torch.data import synthetic as t_synth
        port = run(t_stream, t_synth, t_metrics, device="cpu")
        print(json.dumps({"port": port}), flush=True)
        for key in ("clean", "update", "budget"):
            a = {k: v for k, v in jax_out[key].items() if k != "s"}
            b = {k: v for k, v in port[key].items() if k != "s"}
            print(key, "equal" if a == b else f"DIFFER: {a} vs {b}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
