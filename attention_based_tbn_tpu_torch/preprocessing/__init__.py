"""Epic-Kitchens preprocessing CLIs, the JAX package's four with their
arguments: ``create_symlinks`` (0-indexed frame link trees),
``create_flow_pickle`` (flow JPEG pairs -> ``.npz`` stacks, decoded by the
port's native library), ``create_audio_pickle`` (WAV -> ``.npy``) and
``create_split`` (seen / unseen split lists). Each runs as
``python -m attention_based_tbn_tpu_torch.preprocessing.<name>``."""
