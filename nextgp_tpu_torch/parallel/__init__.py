"""Multi-rank execution on torch.distributed: the (chains, shards) mesh and
the sharded sweep (sharded.py), start-up and divergence checks
(multihost.py)."""
