"""System models (the rigid quadrotor-payload model)."""
