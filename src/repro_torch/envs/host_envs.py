"""NumPy host-side environments: the port's own copy of
``repro.envs.host_envs`` (the port imports nothing of ``repro``).

The paper's W sampler threads step ALE on the CPU while the GPU trains.
The Table 1 host runner (``core.host_runner``) steps these numpy envs
in host Python while inference and updates run on the card, so host
work and device work overlap as in Figure 2 of the paper.

The dynamics are ``envs.games``' catch at its defaults, in integer
arithmetic.
"""

from __future__ import annotations

import numpy as np

SIZE = 10


class HostCatch:
    """One Catch environment stepped on the host."""

    n_actions = 3
    channels = 2

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.ball_x = int(self.rng.randint(0, SIZE))
        self.ball_y = 0
        self.paddle_x = int(self.rng.randint(0, SIZE))
        self.t = 0
        return self.render()

    def step(self, action: int):
        self.paddle_x = int(np.clip(self.paddle_x + [-1, 0, 1][action], 0,
                                    SIZE - 1))
        self.ball_y += 1
        done = self.ball_y >= SIZE - 1
        reward = 0.0
        if done:
            reward = 1.0 if abs(self.ball_x - self.paddle_x) <= 1 else -1.0
            obs = self.render()
            self.reset()
            return obs, reward, True
        self.t += 1
        return self.render(), reward, False

    def render(self) -> np.ndarray:
        g = np.zeros((SIZE, SIZE, 2), np.float32)
        g[min(self.ball_y, SIZE - 1), self.ball_x, 0] = 1.0
        g[SIZE - 1, self.paddle_x, 1] = 1.0
        return g

    def gray84(self) -> np.ndarray:
        w = np.linspace(1.0, 0.4, self.channels)
        gray = np.clip(self.render() @ w, 0, 1)
        up = np.kron(gray, np.ones((8, 8), np.float32))
        up = np.pad(up, 2)
        return (up * 255).astype(np.uint8)
