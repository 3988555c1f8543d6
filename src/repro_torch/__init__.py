"""PyTorch/CUDA port of the DQN reproduction (``repro``, the JAX
reference). The layout mirrors ``repro``: a module here and its
counterpart there share a path. Entry point:
``python -m repro_torch.launch.rl_train --spec FILE``."""
