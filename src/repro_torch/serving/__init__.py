"""Fault-tolerant online serving runtime over
:class:`~repro_torch.api.EmdIndex`.

``EmdServer`` forms device batches out of concurrent single-query callers
(micro-batching queue), survives launch failures and deadline pressure by
degrading down a validated ladder of cascade presets (``ServingPolicy``),
and keeps the index crash-safe through generational snapshot/restore
(``serving.lifecycle``), with deterministic chaos injection for tests
(``serving.chaos``). The port's copy of the JAX package's ``serving``.

    from repro_torch.serving import EmdServer, ServingPolicy
    server = EmdServer(index, ServingPolicy(ladder=("primary", "fast",
                                                    "wcd")))
    async with server:
        res = await server.search(q_ids, q_w)
    print(res.tier, res.expected_recall, res.indices)
"""
from repro_torch.serving.chaos import (ChaosInjector, ChaosSchedule,
                                       FaultInjected, corrupt_checkpoint)
from repro_torch.serving.lifecycle import (RestoredSnapshot, restore_latest,
                                           restore_server, restore_snapshot,
                                           snapshot)
from repro_torch.serving.policy import (TIER_RECALL, ServerOverloaded,
                                        ServingPolicy, ServingTier,
                                        resolve_tier, validate_ladder)
from repro_torch.serving.server import EmdServer, ServeResult, ServerStats

__all__ = [
    "TIER_RECALL", "ChaosInjector", "ChaosSchedule", "EmdServer",
    "FaultInjected", "RestoredSnapshot", "ServeResult", "ServerOverloaded",
    "ServerStats", "ServingPolicy", "ServingTier", "corrupt_checkpoint",
    "resolve_tier", "restore_latest", "restore_server", "restore_snapshot",
    "snapshot", "validate_ladder",
]
