"""Distribution: sharding rules (DP/TP/EP/SP) + pipeline parallelism."""
