"""Generalized Concurrent Training for the LLM architectures: the port of
``repro.core.actor_learner``.

An off-policy actor/learner fine-tuning loop where

  * the **actor** generates with ``decode_step`` from the *time-delayed*
    parameters θ⁻ (Concurrent Training's substitution) over W streams
    batched into one decode call per token (Synchronized Execution);
  * the **learner** makes reward-weighted next-token updates on θ from a
    frozen replay snapshot of generated sequences;
  * θ⁻ ← θ and the staging flush happen at the cycle boundary, as in
    ``core/concurrent.py``.

The reward is synthetic (no reward model offline): the fraction of
generated tokens in a residue class. One cycle follows the reference
step for step: its key schedule (``fold_in(PRNGKey(3), step)`` split in
3), the prompt consumed through ``decode_step`` and ``gen_len`` tokens
drawn by ``rng.categorical``, the updates each on a uniform minibatch of
the snapshot, and the flush at the cursor. The reference's ``lax.scan``s
are Python loops here; parameters are float32, read in the compute
dtype, and every update is a pure function (new trees, nothing written
in place), so θ⁻ is the carry's θ before the updates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import rng
from repro_torch.config import ExecConfig, ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import apply_updates, value_and_grad


@dataclasses.dataclass(frozen=True)
class ALConfig:
    n_streams: int = 8           # W actor streams
    prompt_len: int = 8
    gen_len: int = 24
    replay_capacity: int = 256
    updates_per_cycle: int = 4   # C / F
    minibatch: int = 8
    learning_rate: float = 1e-3
    temperature: float = 1.0
    reward_modulus: int = 7
    reward_target: int = 1
    # prioritized replay over the positive advantage via the segment-tree
    # kernel (uniform minibatches when False)
    prioritized: bool = False
    per_alpha: float = 0.6
    per_eps: float = 1e-3
    # distributional advantage targets through the C51 projection kernel:
    # the learner takes the projection's expectation, a support-clipped
    # advantage
    distributional_adv: bool = False
    adv_atoms: int = 33
    adv_v_min: float = -1.0
    adv_v_max: float = 1.0


def synthetic_reward(tokens: torch.Tensor, prompt_len: int, modulus: int,
                     target: int = 1) -> torch.Tensor:
    """(B, L) -> (B,): the fraction of generated tokens in the target
    residue class mod ``modulus``."""
    gen = torch.remainder(tokens[:, prompt_len:].long(), modulus)
    return torch.mean((gen == target).to(torch.float32), dim=-1)


class ALCarry(NamedTuple):
    params: Dict
    opt_state: Dict
    seqs: torch.Tensor       # replay of token sequences (cap, L) int32
    rewards: torch.Tensor    # (cap,) float32: the stored advantages
    cursor: torch.Tensor
    size: torch.Tensor
    step: torch.Tensor


def make_optimizer(al: ALConfig):
    return adamw(al.learning_rate, grad_clip=1.0, weight_decay=0.0)


def actor_generate(cfg: ModelConfig, ec: ExecConfig, al: ALConfig,
                   target_params: Any, prompts: torch.Tensor,
                   key: torch.Tensor) -> torch.Tensor:
    """prompts (W, prompt_len) int32 -> sequences (W, L) int32, sampled
    with temperature from θ⁻: one batched ``decode_step`` per token for
    all W streams, the prompt's tokens first, then each sampled token
    (the last one too, as the reference's scan does)."""
    W = prompts.shape[0]
    L = al.prompt_len + al.gen_len
    with torch.no_grad():
        cache = T.init_cache(cfg, ec, W, L, device=prompts.device)
        for t in range(al.prompt_len):
            logits, cache = T.decode_step(cfg, ec, target_params, cache,
                                          prompts[:, t:t + 1])
        logits = logits[:, 0]
        toks = []
        for k in rng.split(key, al.gen_len):
            probs = torch.softmax(
                logits[:, : cfg.vocab].to(torch.float32) / al.temperature,
                dim=-1)
            tok = rng.categorical(k, torch.log(probs + 1e-9), axis=-1)
            new, cache = T.decode_step(cfg, ec, target_params, cache,
                                       tok[:, None])
            logits = new[:, 0]
            toks.append(tok)
    return torch.cat([prompts, torch.stack(toks, dim=1)], dim=1)


def learner_loss(cfg: ModelConfig, ec: ExecConfig, al: ALConfig, params,
                 seqs: torch.Tensor, advantages: torch.Tensor
                 ) -> torch.Tensor:
    """Advantage-weighted regression: only better-than-batch-average
    sequences are imitated, and only on their generated positions."""
    L = al.prompt_len + al.gen_len
    logits, aux = T.forward(cfg, ec, params, seqs[:, :-1])
    pos = torch.arange(L - 1, device=seqs.device)[None, :]
    gen_mask = (pos >= al.prompt_len - 1).to(torch.float32)
    w = torch.clamp(advantages, min=0.0)[:, None] * gen_mask
    return softmax_cross_entropy(logits, seqs[:, 1:], cfg.vocab,
                                 mask=w) + aux


def update(cfg: ModelConfig, ec: ExecConfig, al: ALConfig, opt, params,
           opt_state, seqs: torch.Tensor, advantages: torch.Tensor):
    """One learner update on a minibatch: (params, opt_state, loss)."""
    loss, grads = value_and_grad(
        lambda p: learner_loss(cfg, ec, al, p, seqs, advantages), params)
    with torch.no_grad():
        upd, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, upd), opt_state, loss


def make_actor_learner(cfg: ModelConfig, ec: ExecConfig, al: ALConfig):
    """Returns (init(key) -> carry, cycle(carry) -> (carry, metrics)); the
    carry lives on the key's device."""
    L = al.prompt_len + al.gen_len
    opt = make_optimizer(al)

    def init(key: torch.Tensor) -> ALCarry:
        kp = rng.split(key)[0]
        params = T.init_params(cfg, kp, ec, param_dtype=torch.float32)
        dev = key.device

        def zero(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return ALCarry(params=params, opt_state=opt.init(params),
                       seqs=zero(al.replay_capacity, L, dtype=torch.int32),
                       rewards=zero(al.replay_capacity, dtype=torch.float32),
                       cursor=zero(dtype=torch.int32),
                       size=zero(dtype=torch.int32),
                       step=zero(dtype=torch.int32))

    def cycle(carry: ALCarry) -> Tuple[ALCarry, Dict[str, torch.Tensor]]:
        dev = carry.step.device
        key = rng.fold_in(rng.PRNGKey(3, device=dev), carry.step)
        kp, kg, kt = rng.split(key, 3)

        # --- sync point: θ⁻ ← θ; snapshot replay ------------------------
        target_params = carry.params
        seq_snap, rew_snap, size_snap = carry.seqs, carry.rewards, carry.size

        # --- actor: generate W sequences from θ⁻ ------------------------
        prompts = rng.randint(kp, (al.n_streams, al.prompt_len), 0,
                              cfg.vocab)
        seqs = actor_generate(cfg, ec, al, target_params, prompts, kg)
        rewards = synthetic_reward(seqs, al.prompt_len, al.reward_modulus,
                                   al.reward_target)
        advantages = rewards - torch.mean(rewards)

        # --- learner: updates from the frozen snapshot ------------------
        params, opt_state = carry.params, carry.opt_state
        losses = []
        for k in rng.split(kt, al.updates_per_cycle):
            idx = rng.randint(k, (al.minibatch,), 0,
                              torch.clamp(size_snap, min=1)).long()
            params, opt_state, loss = update(cfg, ec, al, opt, params,
                                             opt_state, seq_snap[idx],
                                             rew_snap[idx])
            losses.append(loss)

        # --- flush staged sequences into replay -------------------------
        cap = al.replay_capacity
        idx = torch.remainder(
            carry.cursor.long() + torch.arange(al.n_streams, device=dev),
            cap)
        new_seqs, new_rewards = carry.seqs.clone(), carry.rewards.clone()
        new_seqs[idx] = seqs
        new_rewards[idx] = advantages
        new = ALCarry(
            params=params, opt_state=opt_state, seqs=new_seqs,
            rewards=new_rewards,
            cursor=torch.remainder(carry.cursor + al.n_streams, cap),
            size=torch.clamp(carry.size + al.n_streams, max=cap),
            step=carry.step + 1)
        metrics = {"reward": torch.mean(rewards),
                   "loss": torch.mean(torch.stack(losses))}
        return new, metrics

    return init, cycle
