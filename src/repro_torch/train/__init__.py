"""Training step, state and loop of the port."""
