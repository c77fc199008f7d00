"""The host data pipeline: records, sampling, decode, transforms, priors,
the dataset and the loader that feeds the card."""
