"""Deterministic synthetic token pipeline for the LLM training path: the
port of ``repro.data.synthetic``.

With no corpus offline, the stream is made *learnable*, so that loss
curves descend: a per-sequence mixing recurrence drawn from a few fixed
kernels, with a copy pattern spliced in (a span repeated later in the
sequence), which exercises local statistics and long-range attention.
A batch is a pure function of (config, step), made on the device from
the counter-based PRNG (``repro_torch.rng``), so restoring ``step``
reproduces the exact batch sequence, and every batch equals the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import rng


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    n_kernels: int = 4
    copy_span: int = 16
    seed: int = 0

    def batch(self, step, device="cpu") -> Dict[str, torch.Tensor]:
        """{tokens, labels} (B, S) int32 and mask (B, S) float32 for
        ``step`` (an int or an integer tensor), on ``device``."""
        key = rng.fold_in(rng.PRNGKey(self.seed, device=device), step)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        kk, kt, kc = rng.split(key, 3)
        # per-sequence kernel id drives a cheap mixing recurrence
        kern = rng.randint(kk, (B,), 0, self.n_kernels).long()
        base = rng.randint(kt, (B, S), 0, V).long()
        mult = (kern * 2 + 3)[:, None]
        idx = torch.arange(S, device=key.device)[None, :]
        toks = torch.remainder(torch.div(base, 7, rounding_mode="floor")
                               + mult * idx, V)
        # splice a copy pattern: positions [c, c + span) repeat [0, span)
        c = rng.randint(kc, (B, 1), self.copy_span,
                        S - self.copy_span).long()
        src = toks[:, : self.copy_span]
        pos = idx - c
        in_copy = (pos >= 0) & (pos < self.copy_span)
        gathered = torch.gather(
            src, 1, torch.clamp(pos, 0, self.copy_span - 1))
        toks = torch.where(in_copy, gathered, toks).to(torch.int32)
        labels = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
        mask = torch.ones((B, S), dtype=torch.float32, device=key.device)
        mask[:, -1] = 0.0
        return {"tokens": toks, "labels": labels, "mask": mask}


def lm_batch_specs(vocab: int, seq_len: int, global_batch: int):
    """``meta`` tensors of ``SyntheticLM.batch``'s shapes and dtypes (the
    dry run's stand-ins, no memory)."""
    shape = (global_batch, seq_len)
    return {"tokens": torch.empty(shape, dtype=torch.int32, device="meta"),
            "labels": torch.empty(shape, dtype=torch.int32, device="meta"),
            "mask": torch.empty(shape, dtype=torch.float32, device="meta")}
