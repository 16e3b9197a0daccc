"""The port's open-loop traffic plane (``repro_torch.serve.traffic``)
against ``repro.serve.traffic``.

The 12 tests of ``tests/test_traffic.py``, run against ``repro_torch``;
wherever a test generates a schedule, the port's ``Offered`` list must
equal the reference's for the same spec and keys (field for field, so
every arrival instant bit for bit), and wherever it writes JSON, the
port's string must equal the reference's.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.serve import TenantSpec as RTenantSpec
from repro.serve import TrafficSpec as RTrafficSpec
from repro.serve import generate as r_generate
from repro_torch.serve import TenantSpec, TrafficSpec, generate
from repro_torch.serve.traffic import OP_KINDS

N = 4_000


@pytest.fixture(scope="module")
def keys():
    from repro_torch.core.store import make_uniform_keys
    return make_uniform_keys(N, 7)


def _spec(**kw):
    base = dict(
        tenants=(TenantSpec(name="a", rate_ops_per_s=200_000.0,
                            read_frac=0.8, insert_frac=0.05),
                 TenantSpec(name="b", rate_ops_per_s=100_000.0,
                            arrival="mmpp", keyspace=512, hot_salt=3)),
        duration_s=0.05, seed=9, diurnal_amp=0.4, diurnal_period_s=0.02)
    base.update(kw)
    return TrafficSpec(**base)


def _ref_spec(spec: TrafficSpec) -> RTrafficSpec:
    """The same spec in the reference's classes, through its JSON."""
    return RTrafficSpec.from_json(spec.to_json())


def _gen(spec, keys):
    """The port's schedule, held equal to the reference's."""
    got = generate(spec, keys)
    want = r_generate(_ref_spec(spec), keys)
    assert [dataclasses.astuple(o) for o in got] == \
        [dataclasses.astuple(o) for o in want]
    return got


# ------------------------------------------------------------ determinism
def test_seeded_rerun_is_bit_identical(keys):
    a = _gen(_spec(), keys)
    b = generate(_spec(), keys)
    assert a == b


def test_seed_changes_the_schedule(keys):
    a = generate(_spec(), keys)
    b = _gen(_spec(seed=10), keys)
    assert a != b


def test_schedule_shape(keys):
    offered = _gen(_spec(), keys)
    assert offered
    ts = [o.t_s for o in offered]
    assert ts == sorted(ts)
    assert all(0.0 <= t < 0.05 for t in ts)
    assert {o.tenant for o in offered} == {"a", "b"}
    assert {o.op for o in offered} <= set(OP_KINDS)
    for o in offered:
        assert (o.value is None) == (o.op == "get")


def test_rates_land_near_spec(keys):
    offered = _gen(_spec(), keys)
    per = {"a": 0, "b": 0}
    for o in offered:
        per[o.tenant] += 1
    assert per["a"] == pytest.approx(10_000, rel=0.1)
    assert per["b"] == pytest.approx(5_000, rel=0.15)
    mix = [o.op for o in offered if o.tenant == "a"]
    assert mix.count("get") / len(mix) == pytest.approx(0.8, abs=0.05)
    assert mix.count("insert") / len(mix) == pytest.approx(0.05, abs=0.02)


def test_keyspace_restricts_to_hot_set(keys):
    offered = _gen(_spec(), keys)
    build = set(keys.tolist())
    b_keys = {o.key for o in offered if o.tenant == "b" and o.op != "insert"}
    assert len(b_keys) <= 512
    assert b_keys <= build
    for o in offered:
        if o.op == "insert":
            assert o.key not in build


def test_shared_salt_shares_the_hot_set(keys):
    def hot(salt_a, salt_b):
        spec = _spec(tenants=(
            TenantSpec(name="a", rate_ops_per_s=100_000.0, keyspace=64,
                       hot_salt=salt_a),
            TenantSpec(name="b", rate_ops_per_s=100_000.0, keyspace=64,
                       hot_salt=salt_b)))
        out = {"a": set(), "b": set()}
        for o in _gen(spec, keys):
            out[o.tenant].add(o.key)
        return out
    same = hot(1, 1)
    assert same["a"] == same["b"]
    diff = hot(1, 2)
    assert diff["a"] != diff["b"]


# ------------------------------------------------------------------- JSON
def test_spec_json_round_trip():
    spec = _spec()
    back = TrafficSpec.from_json(spec.to_json())
    assert back == spec
    assert json.loads(spec.to_json()) == spec.to_json_dict()
    # the same canonical JSON as the reference's spec
    ref = RTrafficSpec(
        tenants=tuple(RTenantSpec(**t.to_json_dict()) for t in spec.tenants),
        duration_s=spec.duration_s, seed=spec.seed,
        diurnal_amp=spec.diurnal_amp,
        diurnal_period_s=spec.diurnal_period_s)
    assert spec.to_json() == ref.to_json()
    assert TrafficSpec.from_json(ref.to_json()) == spec


def test_spec_rejects_unknown_fields():
    d = _spec().to_json_dict()
    d["qps"] = 3
    with pytest.raises(ValueError, match="unknown TrafficSpec"):
        TrafficSpec.from_json_dict(d)
    d = _spec().to_json_dict()
    d["tenants"][0]["color"] = "red"
    with pytest.raises(ValueError, match="unknown TenantSpec"):
        TrafficSpec.from_json_dict(d)


@pytest.mark.parametrize("bad", [
    dict(duration_s=0.0),
    dict(diurnal_amp=1.0),
    dict(diurnal_amp=0.3, diurnal_period_s=0.0),
    dict(tenants=()),
    dict(tenants=(TenantSpec(name="a", rate_ops_per_s=1e5),
                  TenantSpec(name="a", rate_ops_per_s=1e5))),
    dict(tenants=(TenantSpec(name="a", rate_ops_per_s=0.0),)),
    dict(tenants=(TenantSpec(name="a", rate_ops_per_s=1e5,
                             read_frac=0.5, insert_frac=0.6),)),
    dict(tenants=(TenantSpec(name="a", rate_ops_per_s=1e5,
                             arrival="pareto"),)),
    dict(tenants=(TenantSpec(name="a", rate_ops_per_s=1e5, arrival="mmpp",
                             burst_factor=1.0),)),
    dict(tenants=(TenantSpec(name="a", rate_ops_per_s=1e5, arrival="mmpp",
                             burst_factor=4.0, burst_frac=0.5),)),
])
def test_invalid_specs_raise(bad, keys):
    with pytest.raises(ValueError) as got:
        generate(_spec(**bad), keys)
    # the reference refuses the same spec with the same message
    rbad = {k: (tuple(RTenantSpec(**dataclasses.asdict(t)) for t in v)
                if k == "tenants" else v) for k, v in bad.items()}
    base = dict(dataclasses.asdict(_spec()), **rbad)
    if "tenants" not in rbad:
        base["tenants"] = tuple(RTenantSpec(**t) for t in base["tenants"])
    with pytest.raises(ValueError) as want:
        r_generate(RTrafficSpec(**base), keys)
    assert str(got.value) == str(want.value)


def test_scaled(keys):
    spec = _spec()
    double = spec.scaled(2.0)
    assert double.total_rate() == pytest.approx(2 * spec.total_rate())
    assert double.duration_s == spec.duration_s
    assert [t.name for t in double.tenants] == [t.name for t in spec.tenants]
    assert double.to_json() == _ref_spec(spec).scaled(2.0).to_json()
    n1 = len(generate(spec, keys))
    n2 = len(_gen(double, keys))
    assert n2 == pytest.approx(2 * n1, rel=0.1)


# --------------------------------------------------- arrival process shape
def test_mmpp_is_burstier_than_poisson(keys):
    def cv2(arrival):
        spec = TrafficSpec(
            tenants=(TenantSpec(name="a", rate_ops_per_s=200_000.0,
                                arrival=arrival, burst_factor=8.0,
                                burst_frac=0.1, burst_mean_s=0.002),),
            duration_s=0.1, seed=3)
        ts = np.array([o.t_s for o in _gen(spec, keys)])
        gaps = np.diff(ts)
        return gaps.var() / gaps.mean() ** 2
    assert cv2("poisson") == pytest.approx(1.0, abs=0.2)
    assert cv2("mmpp") > 1.5


def test_diurnal_modulation_shifts_mass(keys):
    spec = TrafficSpec(
        tenants=(TenantSpec(name="a", rate_ops_per_s=200_000.0),),
        duration_s=0.1, seed=5, diurnal_amp=0.8, diurnal_period_s=0.1)
    ts = np.array([o.t_s for o in _gen(spec, keys)])
    first = (ts < 0.05).sum()
    assert first / len(ts) > 0.6
