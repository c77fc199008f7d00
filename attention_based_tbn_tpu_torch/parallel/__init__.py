"""Training steps and the optimizer of the port."""
