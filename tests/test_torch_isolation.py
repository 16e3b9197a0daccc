"""The port stands alone: no JAX, no ``repro``, no quiet CPU fallback.

* an AST scan of every module under ``src/repro_torch/``, of
  ``chip_smoke.py``, of
  ``tools/{fnm,step,ludo,store,baselines,mesh,faults,cluster,session}_probe.py``,
  of the
  on-card tests (``tests/test_torch_cuda.py``, which must run on the GPU
  machine, and its fault specs, ``tests/_torch_fault_specs.py``), of
  ``tests/test_torch_ludo_plan.py`` and of the spawned mesh rank
  (``tests/_torch_mesh_rank.py``) finds no import of ``jax`` or
  of ``repro``;
* a fresh interpreter that imports ``repro_torch.api`` (and builds a store
  on the CPU), ``repro_torch.net`` (and builds and replays a ``race``
  store's trace on the CPU), the fault plane (``repro_torch.net.faults``
  and ``repro_torch.api.replication``, and serves a replicated store
  through a crash on the CPU), the telemetry and cluster planes
  (``repro_torch.obs``, ``repro_torch.cluster``, ``repro_torch.net.chaos``,
  and runs a chaos run with telemetry on the CPU), ``repro_torch.serve`` (and serves a request
  on the CPU; and its front door, traffic plane and session store, which
  push a schedule through a front door and park an rwkv6 lane through
  the KVS on the CPU), or ``repro_torch.core.sharded_kvs`` (and runs a Get on a
  one-rank CPU mesh), has neither ``jax`` nor ``repro`` in
  ``sys.modules``;
* without a card, the entry points raise unless the caller passes
  ``device="cpu"``, and ``chip_smoke.py`` exits non-zero with no result.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import StoreSpec, open_store
from repro_torch.cache import CuckooPageTable, LudoPageTable
from repro_torch.configs import get_config
from repro_torch.core import baselines, outback, sharded_kvs
from repro_torch.core.cn_cache import CNKeyCache
from repro_torch.core.store import OutbackStore
from repro_torch.core.hashing import splitmix64
from repro_torch.kernels import build
from repro_torch.models.lm import LM, init_params, params_from_reference
from repro_torch.serve import Engine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "test_torch_ludo_plan.py",
    ROOT / "tests" / "_torch_mesh_rank.py",
    ROOT / "tests" / "_torch_fault_specs.py",
    ROOT / "tools" / "fnm_probe.py", ROOT / "tools" / "step_probe.py",
    ROOT / "tools" / "ludo_probe.py", ROOT / "tools" / "store_probe.py",
    ROOT / "tools" / "baselines_probe.py", ROOT / "tools" / "mesh_probe.py",
    ROOT / "tools" / "faults_probe.py",
    ROOT / "tools" / "cluster_probe.py", ROOT / "tools" / "session_probe.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_sources_import_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, json, numpy as np\n"
        "import repro_torch.api as api\n"
        "from repro_torch.core.hashing import splitmix64\n"
        "k = splitmix64(np.arange(1, 200, dtype=np.uint64))\n"
        "st = api.open_store(api.StoreSpec('outback'), k, k, device='cpu')\n"
        "assert st.get_batch(k).found.all()\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_importing_the_net_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, json, numpy as np\n"
        "import repro_torch.net as net\n"
        "import repro_torch.api as api\n"
        "from repro_torch.core.hashing import splitmix64\n"
        "k = splitmix64(np.arange(1, 500, dtype=np.uint64))\n"
        "tr = net.Transport()\n"
        "st = api.open_store(api.StoreSpec('race'), k, k, device='cpu',\n"
        "                    transport=tr)\n"
        "assert st.get_batch(k).found.all() and len(tr) == k.size\n"
        "assert net.simulate(tr.trace, clients=8).n_ops == k.size\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_importing_the_fault_plane_loads_neither_jax_nor_repro():
    """``repro_torch.net.faults`` and ``repro_torch.api.replication``: a
    replicated store through a crash window, in a fresh interpreter."""
    code = (
        "import sys, json, numpy as np\n"
        "from repro_torch.api import replication\n"
        "from repro_torch.net import faults\n"
        "import repro_torch.api as api\n"
        "from repro_torch.core.hashing import splitmix64\n"
        "k = splitmix64(np.arange(1, 500, dtype=np.uint64))\n"
        "sched = faults.FaultSchedule.single_crash(8, 64, lease_term_ops=16)\n"
        "st = api.open_store(api.StoreSpec('outback', replicas=2,\n"
        "                    faults=sched), k, k, device='cpu')\n"
        "for i in range(8):\n"
        "    assert st.get_batch(k[i * 32:(i + 1) * 32]).found.all()\n"
        "assert st.meter_totals().failovers == 1\n"
        "assert isinstance(st.inner.inner.inner,\n"
        "                  replication.ReplicaSetAdapter)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["repro_torch.obs", "repro_torch.cluster",
                                    "repro_torch.net.chaos"])
def test_importing_the_telemetry_and_cluster_planes_loads_neither_jax_nor_repro(
        module):
    """``repro_torch.obs``, ``repro_torch.cluster`` and
    ``repro_torch.net.chaos``, each imported alone in a fresh interpreter
    that then runs a small telemetry-on chaos run on the CPU."""
    code = (
        "import sys, json, importlib\n"
        f"importlib.import_module({module!r})\n"
        "from repro_torch.net.chaos import run_chaos\n"
        "rep = run_chaos(1, n_keys=300, n_ops=600, telemetry=True,\n"
        "                device='cpu')\n"
        "assert rep.passed and rep.telemetry_sig is not None\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", ["repro_torch.serve.frontdoor",
                                    "repro_torch.serve.traffic",
                                    "repro_torch.serve.session_store",
                                    "repro_torch.models.rwkv"])
def test_importing_the_serving_plane_loads_neither_jax_nor_repro(module):
    """The front door, the traffic plane, the session store and the rwkv
    block, each imported alone in a fresh interpreter that then pushes a
    generated schedule through a front door and parks and resumes a
    reduced rwkv6 lane through the KVS on the CPU."""
    code = (
        "import sys, json, importlib, numpy as np\n"
        f"importlib.import_module({module!r})\n"
        "import repro_torch.api as api\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core.hashing import splitmix64\n"
        "from repro_torch.models.lm import LM\n"
        "from repro_torch.serve import (Engine, FrontDoor, FrontDoorConfig,\n"
        "    KVSessionStore, Request, TenantSpec, TrafficSpec, generate)\n"
        "k = splitmix64(np.arange(1, 500, dtype=np.uint64))\n"
        "st = api.open_store(api.StoreSpec('outback'), k, k, device='cpu')\n"
        "spec = TrafficSpec(tenants=(TenantSpec('a', 1e5),), duration_s=1e-3)\n"
        "fd = FrontDoor(st, FrontDoorConfig(singleflight=True, window=16))\n"
        "assert all(r.found for r in fd.run(generate(spec, k)))\n"
        "m = LM(get_config('rwkv6-1.6b', reduced=True), device='cpu')\n"
        "eng = Engine(m, m.init(0), lanes=2, max_seq=16,\n"
        "             session_store=KVSessionStore(device='cpu'))\n"
        "eng.submit(Request(rid=1, prompt=[3, 4], max_new=4))\n"
        "eng.step()\n"
        "eng.resume(eng.park(0))\n"
        "eng.run()\n"
        "assert eng.stats.finished == 1 and eng.stats.resumed == 1\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_session_store_raises_without_cuda(monkeypatch):
    """``KVSessionStore`` opens its store on CUDA unless given
    ``device="cpu"``."""
    from repro_torch.serve import KVSessionStore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVSessionStore(bootstrap_keys=64)
    ss = KVSessionStore(bootstrap_keys=64, device="cpu")
    assert ss.store.engine.tables[0].device.type == "cpu"


def test_cluster_entry_points_raise_without_cuda(monkeypatch):
    """A cluster (and a chaos run) builds its MN pool and CN caches on CUDA
    unless given ``device="cpu"``."""
    from repro_torch.cluster import cluster_of
    from repro_torch.net.chaos import run_chaos
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = splitmix64(np.arange(1, 300, dtype=np.uint64))
    spec = StoreSpec("outback-dir", cache_budget_bytes=4096)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cluster_of(spec, keys, keys, n_cns=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_chaos(1, n_keys=64, n_ops=64)
    cl = cluster_of(spec, keys, keys, n_cns=2, device="cpu")
    assert {t.device.type for t in cl.engine.tables} == {"cpu"}
    assert cl.cns[1].get_batch(keys).found.all()


def test_replicated_entry_points_raise_without_cuda(monkeypatch):
    """A replicated, faulted store runs on CUDA unless given
    ``device="cpu"``; every replica is on the caller's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = splitmix64(np.arange(1, 300, dtype=np.uint64))
    spec = StoreSpec("outback-dir", replicas=3, placement="hrw",
                     placement_k=2, faults={"events": []})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_store(spec, keys, keys)
    st = open_store(spec, keys, keys, device="cpu")
    reps = st.inner.inner.inner.replicas
    assert len(reps) == 3
    assert {t.device.type for r in reps for t in r.engine.tables} == {"cpu"}
    assert st.get_batch(keys).found.all()


def test_importing_the_mesh_port_loads_neither_jax_nor_repro(tmp_path):
    code = (
        "import sys, json, numpy as np, torch\n"
        "import torch.distributed as dist\n"
        "from repro_torch.core import sharded_kvs as skv\n"
        "from repro_torch.core.hashing import splitmix64, split_u64\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/r',"
        " rank=0, world_size=1)\n"
        "mesh = skv.make_mesh((1, 1), device='cpu')\n"
        "k = splitmix64(np.arange(1, 500, dtype=np.uint64))\n"
        "st = skv.build_sharded(k, k, num_shards=1, data_parallel=1)\n"
        "fn, _ = skv.make_get_fn(mesh, st, k.size)\n"
        "lo, hi = (torch.from_numpy(x.view(np.int32)) for x in split_u64(k))\n"
        "v_lo, v_hi, match = fn(lo, hi, *skv.place_state(mesh, st))\n"
        "assert bool(match.all())\n"
        "dist.destroy_process_group()\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_mesh_entry_points_raise_without_cuda(monkeypatch):
    """``make_mesh`` and ``open_store`` with kind ``sharded`` run on CUDA
    unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = splitmix64(np.arange(1, 300, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_store(StoreSpec("sharded"), keys, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded_kvs.make_mesh((1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded_kvs.build_sharded(keys, keys, num_shards=1, data_parallel=1,
                                  keep_shards=True)
    st = open_store(StoreSpec("sharded"), keys, keys, device="cpu")
    assert {sh.device.type for sh in st.engine.shards} == {"cpu"}
    assert st.get_batch(keys).found.all()
    with pytest.raises(RuntimeError, match="initialized default process"):
        sharded_kvs.make_mesh((1, 1), device="cpu")


def test_baseline_entry_points_raise_without_cuda(monkeypatch):
    """The four baselines and ``open_store`` with their kinds run on CUDA
    unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = splitmix64(np.arange(1, 300, dtype=np.uint64))
    for kind, cls in (("race", baselines.RaceKVS),
                      ("mica", baselines.MicaKVS),
                      ("cluster", baselines.ClusterKVS),
                      ("dummy", baselines.DummyKVS)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            open_store(StoreSpec(kind), keys, keys)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(keys, keys)
        st = open_store(StoreSpec(kind), keys, keys, device="cpu")
        assert st.engine.device.type == "cpu"
        assert all(x.device.type == "cpu" for x in st.engine.mn_arrays())


def test_importing_the_serving_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, json\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.lm import LM\n"
        "from repro_torch.serve import Engine, Request\n"
        "m = LM(get_config('llama3.2-1b', reduced=True), device='cpu')\n"
        "eng = Engine(m, m.init(0), lanes=2, max_seq=16)\n"
        "eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))\n"
        "eng.run()\n"
        "assert eng.stats.finished == 1\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_kernels_are_built_from_the_repo_sources_only():
    srcs = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert srcs == ["fused_norm_matmul.cu", "ludo_lookup.cu",
                    "paged_attention.cu", "slot_unpack.cu"]
    assert set(build.SIGNATURES) == {"ludo_lookup", "slot_unpack",
                                     "paged_attention",
                                     "cuckoo_paged_attention",
                                     "fused_norm_matmul"}
    assert build.LIBRARIES == [s[:-3] for s in srcs]
    assert build.BUILD_DIR == ROOT / "src" / "repro_torch" / "kernels" / "_build"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "/src/repro_torch/kernels/_build/" in gitignore


def test_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means CUDA: no card is an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = splitmix64(np.arange(1, 100, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_store(StoreSpec("outback"), keys, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        outback.OutbackShard(keys, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LudoPageTable(64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CuckooPageTable(64)
    assert open_store(StoreSpec("outback"), keys, keys,
                      device="cpu").engine.device.type == "cpu"
    assert LudoPageTable(64, device="cpu").device.type == "cpu"


def test_cached_and_directory_entry_points_raise_without_cuda(monkeypatch):
    """The CN cache, the directory store and ``open_store`` with either run
    on CUDA unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = splitmix64(np.arange(1, 300, dtype=np.uint64))
    for spec in (StoreSpec("outback", cache_budget_bytes=1 << 14),
                 StoreSpec("outback-dir"),
                 StoreSpec("outback-dir", cache_budget_bytes=1 << 14)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            open_store(spec, keys, keys)
        st = open_store(spec, keys, keys, device="cpu")
        assert st.engine.device.type == "cpu"
        assert st.get_batch(keys).found.all()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OutbackStore(keys, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNKeyCache(1 << 14)
    store = OutbackStore(keys, keys, device="cpu", cn_cache_budget_bytes=4096)
    assert store.cn_cache.device.type == "cpu"
    assert {t.device.type for t in store.tables} == {"cpu"}


def test_model_entry_points_raise_without_cuda(monkeypatch):
    """``LM``, ``init_params``, ``params_from_reference`` and so ``Engine``
    run on CUDA unless given ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-1b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({"embed": np.zeros((2, 2), np.float32)},
                              device=None)
    model = LM(cfg, device="cpu")
    eng = Engine(model, init_params(cfg, device="cpu"), lanes=2, max_seq=8)
    assert model.device.type == "cpu"
    assert eng.cache["length"].device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    env = dict(os.environ, PYTHONPATH="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:  # a directory with chip_smoke.py and nothing else
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
