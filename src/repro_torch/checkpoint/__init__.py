"""Checkpoints in the JAX package's .npz layout (``checkpoint.ckpt``)."""

from repro_torch.checkpoint.ckpt import (RESTORE_ERRORS,  # noqa: F401
                                         latest_step, list_steps,
                                         prune_steps, restore_checkpoint,
                                         restore_latest, save_checkpoint,
                                         trim_metrics_jsonl)
