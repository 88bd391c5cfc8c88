"""Agent sharding on one card: the consensus-exchange seam and the sharded
controller steps."""
