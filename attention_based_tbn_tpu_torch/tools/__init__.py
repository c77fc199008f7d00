"""Entry points of the port: serving, export, evaluation, the training loop,
the visualizer."""
