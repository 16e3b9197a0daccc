"""The index engine: hashing, the Ludo/Othello build, ``OutbackShard``, the
CN hot-key cache and the ``OutbackStore`` directory with its §4.4 resize.

The port of ``repro.core``'s exports with the four comparison baselines,
less the sharded mesh engine, which is not ported yet."""

from repro_torch.core.baselines import ClusterKVS, DummyKVS, MicaKVS, RaceKVS
from repro_torch.core.cn_cache import (CNCacheStats, CNKeyCache,
                                       ShardedCNCache, cache_probe, neg_probe)
from repro_torch.core.ludo import LudoBuildError, LudoCN, build as ludo_build
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.othello import (Othello, OthelloBuildError,
                                      build as othello_build)
from repro_torch.core.outback import GetResult, OutbackShard, ShardFullError
from repro_torch.core.overflow import OverflowCache
from repro_torch.core.store import OutbackStore, ResizeEvent, make_uniform_keys

__all__ = [
    "CNCacheStats", "CNKeyCache", "ClusterKVS", "CommMeter", "DummyKVS",
    "GetResult", "LudoBuildError", "LudoCN", "MSG_BYTES", "MicaKVS",
    "Othello", "OthelloBuildError", "OutbackShard", "OutbackStore",
    "OverflowCache", "RaceKVS", "ResizeEvent", "ShardFullError",
    "ShardedCNCache", "cache_probe", "ludo_build", "make_uniform_keys",
    "neg_probe", "othello_build",
]
