"""Tensor ops of the port: the hand-written CUDA kernels (``kernels``,
built by ``build``), the in-forward spectrogram and torch-semantics pools."""
