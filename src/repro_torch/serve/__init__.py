"""Serving: the continuous-batching ``Engine`` over ``models.lm.LM``."""

from repro_torch.serve.engine import Engine, EngineStats, Request

__all__ = ["Engine", "EngineStats", "Request"]
