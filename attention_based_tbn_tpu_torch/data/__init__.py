"""Data-side helpers the model needs (attention priors)."""
