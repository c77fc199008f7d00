"""PyTorch/CUDA port of the attention-based Temporal Binding Network.

A second package beside the JAX one (``attention_based_tbn_tpu``), which
stays the reference: the same config keys, the same model graph and the
reference PyTorch state-dict layout. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, and raise when no
card is present. Imports torch, numpy, scipy and yaml; never JAX and never
the JAX package.
"""
