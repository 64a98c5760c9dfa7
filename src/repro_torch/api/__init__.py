"""The port's serving surface: ``EmdIndex`` configured by ``EngineConfig``."""
from repro_torch.api.config import BACKENDS, METHODS, EngineConfig
from repro_torch.api.index import EmdIndex, corpus_from_numpy

__all__ = ["BACKENDS", "METHODS", "EmdIndex", "EngineConfig",
           "corpus_from_numpy"]
