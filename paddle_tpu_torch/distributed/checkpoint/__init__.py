"""Checkpoints (counterpart of paddle_tpu/distributed/checkpoint).

Only the manager's commit protocol is ported (``manager.py``); the
sharded save and reshard-on-load store and ``CheckpointManager`` itself
are ROADMAP.md A.6.
"""
