"""Controllers: consensus ADMM, low-level SO(3) control, shared types."""
