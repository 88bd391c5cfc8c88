"""Math and solver cores: batched SO(3) ops, the conic-QP solver and the
whole-solve ADMM kernel."""
