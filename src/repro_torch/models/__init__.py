"""The model zoo of the port, in PyTorch: the transformer family, RWKV-6, Jamba (with its Mamba block) and Whisper."""
