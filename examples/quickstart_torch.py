"""Quickstart through the PyTorch port: the Outback KVS end to end.  The
counterpart of ``examples/quickstart.py``; the store's arrays live on the
card unless ``--device cpu``.

Builds a store, runs the paper's four data operations + a resize, and prints
the communication/compute accounting that the paper's evaluation is about,
then the kernel launches of the run (the batched Get locates through
``ludo_lookup`` and decodes through ``slot_unpack`` on the card; the CPU
runs their plain versions and launches none).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
"""

import argparse

import torch

from repro_torch.core import OutbackStore, make_uniform_keys
from repro_torch.core.hashing import splitmix64
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run on the CPU")

    n = 100_000
    keys = make_uniform_keys(n)
    vals = splitmix64(keys)
    store = OutbackStore(keys, vals, load_factor=0.85, num_compute_nodes=2,
                         device=args.device)

    # --- Get: ONE round trip, zero memory-node compute --------------------
    r = store.get(int(keys[42]))
    print(f"get(k) -> {r.value == int(vals[42])}, round_trips={r.round_trips}")

    # --- batched Get (the kernels' hot path) -------------------------------
    v_lo, v_hi, match = store.get_batch(keys[:8192])
    rate = float(match.float().mean())
    print(f"batched get: {rate:.4f} match rate")

    # --- Insert / Update / Delete ------------------------------------------
    cases = {}
    for i in range(5000):
        c = store.insert(10**15 + i, i)
        cases[c] = cases.get(c, 0) + 1
    print("insert cases:", cases)
    store.update(10**15, 777)
    assert store.get(10**15).value == 777
    store.delete(10**15 + 1)
    assert store.get(10**15 + 1).value is None

    # --- the decoupling, quantified ----------------------------------------
    m = store.meter_total().per_op()
    t = store.tables[0]
    print(f"CN locator memory: {t.cn_memory_bytes() * 8 / t.n_keys:.2f} bits/key "
          f"(paper: ~5); MN index is "
          f"{t.mn_index_bytes() / max(t.cn_memory_bytes(), 1):.0f}x larger")
    print(f"per-op: round_trips={m['round_trips']:.2f} "
          f"mn_hash_ops={m['mn_hash_ops']:.3f} mn_cmp_ops={m['mn_cmp_ops']:.3f} "
          f"(Get fast path contributes ZERO of either)")
    if store.resize_events:
        ev = store.resize_events[-1]
        print(f"resize: rebuilt {ev.table_keys} keys in {ev.rebuild_seconds:.2f}s, "
              f"locator fetch {ev.locator_bytes / 1e6:.1f} MB/CN, "
              f"{ev.buffered_mutations} buffered mutations replayed")
    print(f"kernel launches: {dict(ops.LAUNCHES)}")
    return dict(match_rate=rate, insert_cases=cases)


if __name__ == "__main__":
    main()
