"""``chip_smoke.py``'s measurement helpers, on the CPU with a stub trace.

A ``torch.profiler`` trace taken late in a long run on the card can hold
none of the launches it timed, or only some of the kernels; ``device_trace``
then takes another trace (up to ``TRACE_TRIES`` in all) until one holds
every named kernel, instead of reporting no device time (which failed phase
4's check ``no device time in the trace`` on one card) or a partial sum.
Also pinned: the kernels phases 6 and 14 name for each plan of the
forward and of the backward, phase 14's bound of the backward, and its
like-for-like device times (``device_busy_ms``: one a trace, a trace that
holds no device operation retaken).
"""

import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


class _Trace:
    """A profiler stand-in whose n-th trace holds the events of ``plan``."""

    plan: list = []
    taken = 0

    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        _Trace.taken += 1
        return False

    def key_averages(self):
        return [types.SimpleNamespace(key=k, count=c, device_time_total=t)
                for k, c, t in _Trace.plan[_Trace.taken - 1]]


@pytest.fixture
def trace(monkeypatch):
    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _Trace.taken = 0
    return _Trace


@pytest.mark.parametrize("empty", [0, 1, 2])
def test_device_times_retakes_a_trace_that_holds_no_launch(trace, empty):
    hit = [("void paged_split_kernel<bf16>", 10, 300.0),
           ("void paged_combine_kernel<64>", 10, 40.0)]
    trace.plan = [[] for _ in range(empty)] + [hit]
    got = chip_smoke.device_times(lambda: None, 10, "paged_split_kernel",
                                  "paged_combine_kernel")
    assert trace.taken == empty + 1
    assert got == pytest.approx({"paged_split_kernel": 0.03,
                                 "paged_combine_kernel": 0.004})
    trace.taken = 0
    assert chip_smoke.device_ms(lambda: None, 10, "paged_split_kernel",
                                "paged_combine_kernel") == pytest.approx(0.034)


def test_device_times_gives_up_after_its_traces(trace):
    trace.plan = [[]] * chip_smoke.TRACE_TRIES + [[("k", 1, 1.0)]]
    assert chip_smoke.device_times(lambda: None, 10, "k") == {}
    assert trace.taken == chip_smoke.TRACE_TRIES == 6
    trace.taken = 0
    assert chip_smoke.device_ms(lambda: None, 10, "k") is None


KERNELS = ("a_kernel", "b_kernel", "c_kernel")


@pytest.mark.parametrize("missing", KERNELS)
def test_device_trace_retakes_a_trace_that_misses_a_kernel(trace, missing):
    full = [(f"void {k}<float>", 10, 100.0 * (i + 1))
            for i, k in enumerate(KERNELS)]
    part = [e for e in full if missing not in e[0]]
    trace.plan = [part, full]
    times, prof = chip_smoke.device_trace(lambda: None, 10, *KERNELS)
    assert trace.taken == 2 and isinstance(prof, _Trace)
    assert times == pytest.approx({"a_kernel": 0.01, "b_kernel": 0.02,
                                   "c_kernel": 0.03})


@pytest.mark.parametrize("missing", KERNELS)
def test_device_trace_returns_what_its_last_trace_held(trace, missing):
    """After TRACE_TRIES partial traces the times lack the kernel, so a
    caller that needs them all (phase 14) sees it and fails."""
    part = [(f"void {k}<float>", 10, 100.0) for k in KERNELS if k != missing]
    trace.plan = [part] * (chip_smoke.TRACE_TRIES + 1)
    times, _ = chip_smoke.device_trace(lambda: None, 10, *KERNELS)
    assert trace.taken == chip_smoke.TRACE_TRIES
    assert sorted(times) == sorted(set(KERNELS) - {missing})


@pytest.mark.parametrize("S,d,F,dt,want", [
    (8, 2048, 2048, 2, ("fused_norm_matmul_mma_kernel",
                        "fused_norm_matmul_combine_kernel")),
    (256, 2048, 8192, 2, ("fused_norm_matmul_rows_kernel",
                          "fused_norm_matmul_wgmma_kernel")),
    (256, 2048, 8192, 4, ("fused_norm_matmul_rows_kernel",
                          "fused_norm_matmul_fma_kernel")),
    (256, 2048, 131, 2, ("fused_norm_matmul_stream_kernel",
                         "fused_norm_matmul_combine_kernel")),
    (8, 32, 131, 4, ("fused_norm_matmul_stream_kernel",)),
])
def test_fnm_kernels_of_names_what_the_plan_launches(S, d, F, dt, want):
    from repro_torch.kernels import ops
    plan = ops.fused_norm_matmul_plan(S, d, F, dt, 132)
    got = chip_smoke.fnm_kernels_of(plan)
    assert got == want and set(got) <= set(ops.FNM_KERNELS)


@pytest.mark.parametrize("F,dtype,by", [
    (2048, torch.bfloat16, "operations"), (512, torch.bfloat16, "bytes"),
    (8192, torch.bfloat16, "operations"), (2048, torch.float32, "operations"),
    (512, torch.float32, "operations"), (8192, torch.float32, "operations")])
def test_fnmb_bound_is_the_larger_of_bytes_and_operations(F, dtype, by):
    S = d = 2048
    elt = dtype.itemsize
    by_bytes = (2 * S * d + 2 * d + 2 * d * F + S * F) * elt \
        / chip_smoke.HBM_BYTES_PER_S * 1e3
    peak = chip_smoke.BF16_TC_FLOPS_PER_S if dtype == torch.bfloat16 \
        else chip_smoke.F32_FLOPS_PER_S
    by_ops = 2 * S * d * F / peak * 1e3
    got, kind = chip_smoke.fnmb_bound(S, d, F, dtype)
    assert got == pytest.approx(max(by_bytes, by_ops))
    assert kind == by


@pytest.mark.parametrize("S,d,F,elt,aligned,want", [
    (2048, 2048, 8192, 2, True, ("fused_norm_matmul_bwd_wgmma_kernel",)),
    (2048, 2048, 512, 2, True, ("fused_norm_matmul_bwd_wgmma_kernel",
                                "fused_norm_matmul_bwd_dwsum_kernel")),
    (9, 64, 131, 2, True, ("fused_norm_matmul_bwd_dw_kernel",)),
    (96, 256, 512, 2, False, ("fused_norm_matmul_bwd_dw_kernel",)),
    (2048, 2048, 8192, 4, True, ("fused_norm_matmul_bwd_dw_kernel",)),
])
def test_fnmb_kernels_of_names_what_the_plan_launches(S, d, F, elt, aligned,
                                                      want):
    from repro_torch.kernels import ops
    plan = ops.fused_norm_matmul_bwd_dw_plan(S, d, F, elt, 132, aligned)
    got = chip_smoke.fnmb_kernels_of(plan)
    assert got == ("fused_norm_matmul_bwd_warp_rows_kernel",
                   "fused_norm_matmul_bwd_reduce_kernel", *want)
    assert set(got) <= set(ops.FNM_BWD_KERNELS)
    # no name holds another: a trace's kernel is matched by substring
    names = ops.FNM_BWD_KERNELS + ops.FNM_KERNELS
    assert not any(a != b and a in b for a in names for b in names)


class _Busy(_Trace):
    """A profiler stand-in whose n-th trace holds device intervals
    ``plan[n - 1]`` (start, end) in us."""

    def __exit__(self, *a):
        _Busy.taken += 1
        return False

    def events(self):
        from torch.autograd import DeviceType
        return [types.SimpleNamespace(
            device_type=DeviceType.CUDA,
            time_range=types.SimpleNamespace(start=a, end=b))
            for a, b in _Busy.plan[_Busy.taken - 1]]


def test_device_busy_ms_takes_each_trace_and_retakes_an_empty_one(
        monkeypatch):
    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", _Busy)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _Busy.taken = 0
    # union of the intervals over 10 calls: 30 us -> 0.003 ms; 50 -> 0.005
    _Busy.plan = [[(0, 20), (10, 30)], [], [(0, 50)], [(5, 15), (20, 40)]]
    got = chip_smoke.device_busy_ms(lambda: None, 10)
    assert _Busy.taken == 4
    assert got == pytest.approx([0.003, 0.005, 0.003])
