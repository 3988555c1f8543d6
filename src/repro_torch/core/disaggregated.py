"""Disaggregated actor/learner, the paper's sampler/trainer split: the
port of ``repro.core.disaggregated``.

The paper runs the sampler on the CPU and the trainer on the GPU,
synchronizing only at θ⁻ ← θ. Here the actor and the learner each get a
device, and θ⁻ crosses once per cycle:

    actor:     generate from θ⁻ (frozen for the whole cycle)
    learner:   C/F updates on θ from the replay snapshot
    boundary:  θ⁻ ← a copy of θ on the actor's device (the one transfer)

The actor consumes θ⁻ and the learner produces θ', so within a cycle
neither waits for the other. On two devices each queues its work on its
own device. On one card (``actor_device == learner_device``, CUDA) the
two run on two CUDA streams of that card, Figure 1b of the paper on one
card: θ⁻ is copied on the actor's stream before the learner's first
update, the flush waits for both streams, and every tensor that one
stream allocates and another reads is marked with ``record_stream``. On
the CPU the two run in order. The learner may sample by the positive
advantage through the segment-tree kernel (``prioritized``: the sum tree
built by ``tree_build`` once per learner call) and may take its
advantages through the C51 projection kernel (``distributional_adv``),
as the reference's does; it is skipped while the replay is empty.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch import rng
from repro_torch.config import ExecConfig, ModelConfig
from repro_torch.core.actor_learner import (ALConfig, actor_generate,
                                            make_optimizer, synthetic_reward,
                                            update)
from repro_torch.core.replay import stratified_indices
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as T
from repro_torch.optim.base import flatten, unflatten


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def _record(stream: Optional[torch.cuda.Stream], *trees: Any) -> None:
    """Mark every tensor of ``trees`` as in use on ``stream``, so that
    the caching allocator does not hand its memory out again before the
    stream's queued work on it has run."""
    if stream is not None:
        for tree in trees:
            for t in _leaves(tree):
                t.record_stream(stream)


class DisaggregatedActorLearner:
    """Actor on one device (or stream), learner on another; θ⁻ crosses
    once per cycle. ``cursor``, ``size`` and ``step`` are Python ints."""

    def __init__(self, cfg: ModelConfig, ec: ExecConfig, al: ALConfig,
                 actor_device="cpu", learner_device="cpu", seed: int = 0):
        self.cfg, self.ec, self.al = cfg, ec, al
        self.actor_device = torch.device(actor_device)
        self.learner_device = torch.device(learner_device)
        self.opt = make_optimizer(al)
        one_card = (self.actor_device == self.learner_device
                    and self.actor_device.type == "cuda")
        self.actor_stream = self.learner_stream = None
        if one_card:
            self.actor_stream = torch.cuda.Stream(self.actor_device)
            self.learner_stream = torch.cuda.Stream(self.learner_device)
        L = al.prompt_len + al.gen_len
        dev = self.learner_device
        self.params = T.init_params(cfg, rng.PRNGKey(seed, device=dev), ec,
                                    param_dtype=torch.float32)   # θ
        self.opt_state = self.opt.init(self.params)
        self.seqs = torch.zeros((al.replay_capacity, L), dtype=torch.int32,
                                device=dev)
        self.advs = torch.zeros((al.replay_capacity,), dtype=torch.float32,
                                device=dev)
        self.cursor = 0
        self.size = 0
        self.step = 0

    # ------------------------------------------------------------------
    def _on(self, stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    def _actor(self, target_params, prompts: torch.Tensor,
               key: torch.Tensor):
        """(seqs (W, L), advantages (W,), mean reward) from θ⁻."""
        al = self.al
        seqs = actor_generate(self.cfg, self.ec, al, target_params, prompts,
                              key)
        rewards = synthetic_reward(seqs, al.prompt_len, al.reward_modulus,
                                   al.reward_target)
        return seqs, rewards - torch.mean(rewards), torch.mean(rewards)

    def _learner(self, params, opt_state, seqs: torch.Tensor,
                 advantages: torch.Tensor, size: int, key: torch.Tensor):
        """``updates_per_cycle`` updates from the replay snapshot:
        (params, opt_state, mean loss)."""
        al, dev = self.al, seqs.device
        if al.distributional_adv:
            # a point mass at the mid-support atom, shifted by the
            # advantage, projected onto the fixed support; its
            # expectation is the advantage clipped smoothly into
            # [adv_v_min, adv_v_max]
            z = kops.support(al.adv_atoms, al.adv_v_min, al.adv_v_max,
                             device=dev)
            mid = torch.zeros((advantages.shape[0], al.adv_atoms),
                              dtype=torch.float32, device=dev)
            mid[:, al.adv_atoms // 2] = 1.0
            m = kops.categorical_projection(
                mid, advantages - z[al.adv_atoms // 2],
                torch.zeros_like(advantages), v_min=al.adv_v_min,
                v_max=al.adv_v_max, gamma_n=1.0)
            advantages = torch.sum(m * z, dim=-1)
        size_t = torch.full((), size, dtype=torch.int32, device=dev)
        if al.prioritized:
            # mass follows the positive advantage, which is what the loss
            # weights; unfilled slots get none
            cap = al.replay_capacity
            filled = torch.arange(cap, device=dev) < size
            pri = torch.where(filled, torch.pow(
                torch.clamp(advantages, min=0.0) + al.per_eps, al.per_alpha),
                0.0)
            leaves = torch.zeros((kops.next_pow2(cap),), dtype=torch.float32,
                                 device=dev)
            leaves[:cap] = pri
            tree = kops.tree_build(leaves)
        losses = []
        for k in rng.split(key, al.updates_per_cycle):
            if al.prioritized:
                idx = stratified_indices(tree, k, al.minibatch, size_t)
            else:
                idx = rng.randint(k, (al.minibatch,), 0, max(size, 1))
            idx = idx.long()
            params, opt_state, loss = update(
                self.cfg, self.ec, al, self.opt, params, opt_state,
                seqs[idx], advantages[idx])
            losses.append(loss)
        return params, opt_state, torch.mean(torch.stack(losses))

    # ------------------------------------------------------------------
    def cycle(self) -> Dict[str, float]:
        al = self.al
        ad, ld = self.actor_device, self.learner_device
        key = rng.fold_in(rng.PRNGKey(3, device=ld), self.step)
        kp, kg, kt = rng.split(key, 3)
        main = (torch.cuda.current_stream(ld) if self.actor_stream
                is not None else None)

        # --- boundary: θ⁻ ← θ crosses to the actor ----------------------
        with self._on(self.actor_stream):
            if main is not None:
                self.actor_stream.wait_stream(main)
                _record(self.actor_stream, self.params)
            target = unflatten({k: v.to(ad, copy=True)
                                for k, v in flatten(self.params).items()})
            copied = (self.actor_stream.record_event() if main is not None
                      else None)
            # --- the actor: its own stream or device -------------------
            prompts = rng.randint(kp.to(ad), (al.n_streams, al.prompt_len),
                                  0, self.cfg.vocab)
            seqs_new, advs_new, mean_reward = self._actor(target, prompts,
                                                          kg.to(ad))

        # --- the learner: neither result is needed to start the other ---
        with self._on(self.learner_stream):
            if main is not None:
                self.learner_stream.wait_stream(main)
                self.learner_stream.wait_event(copied)
                _record(self.learner_stream, self.params, self.opt_state,
                        self.seqs, self.advs, kt)
            if self.size > 0:
                self.params, self.opt_state, loss = self._learner(
                    self.params, self.opt_state, self.seqs, self.advs,
                    self.size, kt)
            else:
                loss = torch.zeros((), dtype=torch.float32, device=ld)

        # --- flush staged sequences into the learner-side replay --------
        if main is not None:
            main.wait_stream(self.actor_stream)
            main.wait_stream(self.learner_stream)
            _record(main, seqs_new, advs_new, mean_reward, loss)
        seqs_l = seqs_new.to(ld)
        advs_l = advs_new.to(ld)
        idx = torch.remainder(self.cursor + torch.arange(
            al.n_streams, device=ld), al.replay_capacity)
        self.seqs[idx] = seqs_l
        self.advs[idx] = advs_l
        self.cursor = (self.cursor + al.n_streams) % al.replay_capacity
        self.size = min(self.size + al.n_streams, al.replay_capacity)
        self.step += 1
        return {"reward": float(mean_reward), "loss": float(loss)}
