"""The index engine: hashing, the Ludo/Othello build, ``OutbackShard``, the
CN hot-key cache and the ``OutbackStore`` directory with its §4.4 resize.

The port of ``repro.core``'s exports: with the four comparison baselines
and the sharded mesh engine (``build_sharded`` / ``place_state`` /
``make_get_fn`` over a ``make_mesh`` of ``torch.distributed`` ranks)."""

from repro_torch.core.baselines import ClusterKVS, DummyKVS, MicaKVS, RaceKVS
from repro_torch.core.cn_cache import (CNCacheStats, CNKeyCache,
                                       ShardedCNCache, cache_probe, neg_probe)
from repro_torch.core.ludo import LudoBuildError, LudoCN, build as ludo_build
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.othello import (Othello, OthelloBuildError,
                                      build as othello_build)
from repro_torch.core.outback import GetResult, OutbackShard, ShardFullError
from repro_torch.core.overflow import OverflowCache
from repro_torch.core.sharded_kvs import (RankMesh, ShardedKVSState,
                                          build_sharded, make_get_fn,
                                          make_mesh, place_cache,
                                          place_state)
from repro_torch.core.store import OutbackStore, ResizeEvent, make_uniform_keys

__all__ = [
    "CNCacheStats", "CNKeyCache", "ClusterKVS", "CommMeter", "DummyKVS",
    "GetResult", "LudoBuildError", "LudoCN", "MSG_BYTES", "MicaKVS",
    "Othello", "OthelloBuildError", "OutbackShard", "OutbackStore",
    "OverflowCache", "RaceKVS", "RankMesh", "ResizeEvent", "ShardFullError",
    "ShardedCNCache", "ShardedKVSState", "build_sharded", "cache_probe",
    "ludo_build", "make_get_fn", "make_mesh", "make_uniform_keys",
    "neg_probe", "othello_build", "place_cache", "place_state",
]
