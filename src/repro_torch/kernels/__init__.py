"""Hand-written CUDA kernels of the port (the DQN path and the LLM serve
path), each beside its plain PyTorch version; see ``ops``."""
