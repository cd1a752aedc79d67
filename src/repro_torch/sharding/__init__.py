"""Parameter and optimizer-state sharding rules of the port's mesh."""
