"""Hand-written CUDA kernels of the DQN path, each beside its plain
PyTorch version; see ``ops``."""
