"""paddle_tpu_torch.distributed (counterpart of paddle_tpu/distributed).

Ported so far: the atomic commit protocol of the checkpoint manager
(``checkpoint/manager.py``), which the serving engine's snapshots ride.
Collectives, model-parallel layers, sharding, pipelines and the rest of
the checkpoint manager are ROADMAP.md A.6.
"""
