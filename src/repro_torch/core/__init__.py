"""FedAttn core of the port: partitions, sync schedules, KV aggregation
and the per-task protocol context."""
