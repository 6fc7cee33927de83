"""Rank-side helpers of ``test_torch_sharded.py`` (not collected).

``RankPool`` runs these on every spawned rank, so they live in a module
the ranks can import that pulls in torch and the port only.
"""
import numpy as np
import torch

from repro_torch.engines.sharded import (Mesh, ShardedParams, ShardedState,
                                         sharded_superstep_device)


def conflict_program(hg, fresh, bias, pool, fringe, targets, group_l,
                     select_k):
    """One sharded superstep from an empty image on this rank; returns
    ``(assign, cache, acc, poison, winners, n_conflicts, n_stale)`` as
    numpy, the scratch slots cut off."""
    n, kG = hg.n, fresh.shape[0]
    indptr, indices = hg.device_adjacency("cpu")
    empty_i = torch.full((4,), -1, dtype=torch.int32)
    t = torch.from_numpy
    out = sharded_superstep_device(
        indptr, indices, torch.full((n + 1,), -1, dtype=torch.int32),
        torch.full((n + 1,), -1.0), torch.zeros(kG + 1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), empty_i,
        torch.zeros(4, dtype=torch.int32), empty_i, torch.zeros(4),
        t(fresh), t(bias), t(pool), t(fringe), t(targets),
        torch.zeros(1, dtype=torch.int32), mesh=Mesh.of(None, "cpu"),
        group_l=group_l, tile_l=32, select_k=select_k)
    assign, cache, acc = (x.numpy() for x in out[:3])
    return (assign[:n], cache[:n], acc[:kG],
            *(x.numpy() for x in out[3:]))


def drill(st, seed, k, R, t):
    """JAX's exactness drill (tests/test_hype_sharded.py:188) on a
    sharded state of either package: ten supersteps of seeded fresh
    picks and caps, host injections every third, then a flush."""
    n = st.hg.n
    rng = np.random.default_rng(seed)
    fringe = np.full((k, 1), -1, np.int32)
    empty_pool = np.full((k, 4), -1, np.int32)
    acc = np.zeros(k, dtype=np.int64)
    targets = np.full(k, n, dtype=np.int64)
    wide_v = int(np.argmax(st.deg))
    for step in range(10):
        cand = np.flatnonzero(~st.cache_scored & (st.assignment < 0))
        fresh = np.full((k, R), -1, np.int32)
        if cand.size:
            pick = rng.choice(cand, size=min(k * R - 1, cand.size),
                              replace=False)
            if st.assignment[wide_v] < 0 and wide_v not in pick:
                pick = np.concatenate([[wide_v], pick])
            fresh.reshape(-1)[:pick.size] = pick
        bias = np.where(fresh >= 0, 0, np.inf).astype(np.float32)
        cap = rng.integers(0, t + 1, size=k)
        tgt = (acc + cap).astype(np.int32)
        handle = st.dispatch(fresh, bias, empty_pool, fringe,
                             fresh[fresh >= 0].astype(np.int64), tgt, 32, t)
        st.harvest(handle, acc, targets)
        un = np.flatnonzero(st.assignment < 0)
        if un.size and step % 3 == 0:
            vs = rng.choice(un, size=min(3, un.size), replace=False)
            g = int(rng.integers(0, k))
            st.assign_now(vs, g)
            acc[g] += vs.size
    while st.delta_ids or st.pending_dirty:
        handle = st.dispatch(np.full((k, 1), -1, np.int32),
                             np.full((k, 1), np.inf, np.float32),
                             np.full((k, 1), -1, np.int32), fringe,
                             np.empty(0, dtype=np.int64),
                             acc.astype(np.int32), 32, 1)
        st.harvest(handle, acc, targets)
    return st


def cache_exact(hg, seed, k, R, t):
    """``drill`` on this rank's ``ShardedState``. Returns the device
    cache, assignment and totals, the host mirror, the scored mask and
    the admission conflicts."""
    st = drill(ShardedState(hg, k, ShardedParams(seed=seed, t=t, rows=R),
                            Mesh.of(None, "cpu"), "cpu"), seed, k, R, t)
    n = hg.n
    return (st.dev_cache.numpy()[:n], st.dev_assign.numpy()[:n],
            st.dev_acc.numpy()[:k], st.assignment.copy(),
            st.cache_scored.copy(), st.stats.admission_conflicts)


def desync(failing_rank):
    """``failing_rank`` raises before the superstep's collective; the
    others enter it and wait for the group's timeout."""
    mesh = Mesh.of(None, "cpu")
    if mesh.rank == failing_rank:
        raise ValueError("this rank failed before the collective")
    return mesh.all_gather(torch.zeros((1, 2), dtype=torch.int32)).numpy()
