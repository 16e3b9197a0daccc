"""A CN cache's whole state, compared between ``repro`` and the port.

Shared by ``tests/test_torch_cn_cache.py``, ``tests/test_torch_store.py``
and ``tests/test_torch_api.py``."""

import dataclasses

import numpy as np

ARRAYS = ("k_lo", "k_hi", "v_lo", "v_hi", "valid", "ref", "hand", "sketch",
          "nk_lo", "nk_hi", "nvalid")


def ref_state(c) -> dict:
    """A reference cache's state, as ``CNKeyCache.from_reference_state``
    takes it and ``CNKeyCache.state`` gives it."""
    out = {n: np.asarray(getattr(c, n)).copy() for n in ARRAYS}
    out.update(sketch_obs=c._sketch_obs, budget_bytes=c.budget_bytes,
               stats=dataclasses.asdict(c.stats))
    return out


def assert_same_cache(r, t) -> None:
    """The reference cache ``r`` and the port's ``t`` hold the same arrays
    (in the same dtypes), sketch count, budget, statistics and sizes."""
    a, b = ref_state(r), t.state()
    assert a.keys() == b.keys()
    for name in ARRAYS:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert a[name].dtype == b[name].dtype, name
    for name in ("sketch_obs", "budget_bytes", "stats"):
        assert a[name] == b[name], name
    assert (r.nsets, r.nneg, r.sketch_w, r.aging_window, r.capacity,
            r.memory_bytes()) == (t.nsets, t.nneg, t.sketch_w,
                                  t.aging_window, t.capacity,
                                  t.memory_bytes())
