"""Set-up factories and the batched headline rollout."""
