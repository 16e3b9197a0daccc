"""One rank of a CPU mesh world for ``tests/test_torch_sharded_kvs.py``.

    python tests/_torch_mesh_rank.py CASES INIT RANK OUT

``CASES`` is an ``.npz`` written by the test (the keys, values, mesh shape,
the cases as JSON and each case's global query batch), ``INIT`` the file of
a ``file://`` rendezvous, ``RANK`` this rank.  The rank joins a gloo world
of ``D*M`` ranks, builds the port's sharded state, takes its chunk of each
case's batch (``rank * B/(D*M)`` on, as ``P(("data", "model"))`` hands
them out), runs ``make_get_fn`` and writes its outputs to ``OUT``.  It
imports only torch, numpy and ``repro_torch``.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import sharded_kvs as skv
from repro_torch.core.cn_cache import CNKeyCache, ShardedCNCache
from repro_torch.core.hashing import split_u64


def warm_cache(cache, keys, values, rounds: int = 2):
    """Warm a ``CNKeyCache`` of either package the same way: each window of
    256 keys probed, then observed as present with its true values."""
    lo, hi = split_u64(keys)
    v_lo, v_hi = split_u64(values)
    for _ in range(rounds):
        for w in range(0, keys.size, 256):
            s = slice(w, w + 256)
            hit, neg, _, _ = cache.probe_batch(lo[s], hi[s])
            cache.observe_batch(lo[s], hi[s], v_lo[s], v_hi[s],
                                np.ones(lo[s].size, bool), hit, neg)
    return cache


def run_rank(cases_file: str, init_file: str, rank: int, out_file: str):
    data = np.load(cases_file)
    D, M = (int(x) for x in data["shape"])
    world = D * M
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = skv.make_mesh((D, M), device="cpu")
        st = skv.build_sharded(data["keys"], data["vals"], num_shards=M,
                               data_parallel=D)
        blocks = skv.place_state(mesh, st)
        out = {}
        for case in json.loads(str(data["cases"])):
            name = case["name"]
            q = data[f"q_{name}"]
            bpd = q.size // world
            lo, hi = split_u64(q[rank * bpd:(rank + 1) * bpd])
            extra, cache = (), None
            if case["cache"]:
                host = warm_cache(CNKeyCache(case["cache"], device="cpu"),
                                  data[f"w_{name}"], data[f"wv_{name}"])
                cache = ShardedCNCache(host, world)
                extra = skv.place_cache(mesh, cache)
            fn, caps = skv.make_get_fn(mesh, st, bpd,
                                       capacity_slack=case["slack"],
                                       variant=case["variant"], cache=cache)
            res = fn(torch.from_numpy(lo.view(np.int32)),
                     torch.from_numpy(hi.view(np.int32)), *extra, *blocks)
            for field, x in zip(("v_lo", "v_hi", "match", "hit"), res):
                x = x.numpy()
                out[f"{name}/{field}"] = (x.view(np.uint32)
                                          if x.dtype == np.int32 else x)
            out[f"{name}/caps"] = np.asarray(caps)
        np.savez(out_file, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run_rank(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
