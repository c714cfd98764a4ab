"""Iovec-addressed sharded checkpoints + async manager."""
from repro_torch.checkpoint.manager import CheckpointManager
