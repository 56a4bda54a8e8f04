"""Multi-host work sharding."""
