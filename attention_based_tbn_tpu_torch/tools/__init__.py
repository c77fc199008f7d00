"""Entry points of the port: serving, evaluation, the training loop."""
