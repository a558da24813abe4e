"""Training data of the port: deterministic synthetic corpora."""
