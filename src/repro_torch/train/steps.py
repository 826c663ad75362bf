"""Train / prefill / decode step builders (the port of repro/train/steps.py).

make_train_step builds train_step(state, batch) -> (state, metrics):
  - microbatch gradient accumulation (cfg.microbatches), as JAX's lax.scan
    does it: contiguous rows per microbatch, each microbatch's gradient
    (in the parameter dtype) cast to f32 and summed, then divided by M;
  - the f32 loss with label masking (-1 = ignore);
  - the AdamW update (train/optimizer.py);
  - an optional grad_transform hook applied to the accumulated gradient
    before the optimizer (the sketched gradients of the mesh half).

Differences from JAX's step, by design:
  - the state is updated in place and the same TrainState is returned (a
    second copy of a training state would not fit beside the first on
    one card). `TrainState.params` is the model (an nn.Module), as the
    rest of the port passes the model where JAX passes (params, cfg);
  - each parameter's gradient is folded into its f32 accumulator as soon
    as autograd has it (Tensor.register_post_accumulate_grad_hook) and
    dropped, so a microbatch's gradients never live beside the sum: the
    same arithmetic as JAX's scan;
  - JAX's pregather_spec / grad_spec are mesh placements and come with
    the mesh half (distributed/sharding.py); they are left out.

No host sync runs inside the step: the metrics are tensors on the step's
device. `cfg` is kept for the JAX signature of the serving builders; the
model carries it.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import decayed_names
from repro_torch.models.registry import ModelAPI
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


class TrainState(NamedTuple):
    params: nn.Module
    opt: Dict


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked mean CE. logits (B,S,V) f32, labels (B,S) int (-1 ignored);
    the logsumexp over the whole (padded) vocabulary, the mean over
    max(count, 1) labels."""
    mask = labels >= 0
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)


def init_train_state(cfg: ArchConfig, api: ModelAPI, tp: int = 16, *,
                     device=None,
                     generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """The model (drawn from `generator`, seed 0 when None) and zero AdamW
    moments in cfg.optimizer_dtype, on the card unless the caller names
    another device."""
    device = resolve_device(device)
    model = api.init(cfg, tp, device=device, generator=generator)
    opt_cfg = AdamWConfig(moment_dtype=cfg.optimizer_dtype)
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        opt_cfg))


def make_train_step(cfg: ArchConfig, api: ModelAPI, groups: int = 1,
                    grad_transform: Optional[Callable] = None,
                    opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, {"loss", "grad_norm"}).

    batch: dict of (B, ...) tensors; B must divide by cfg.microbatches.
    grad_transform: optional ({name: grad} -> {name: grad}) hook on the
    accumulated gradients. With M = 1 the gradients stay in the parameter
    dtype, as JAX's do; with M > 1 they are the f32 mean.
    """
    opt_cfg = opt_cfg or AdamWConfig(moment_dtype=cfg.optimizer_dtype)
    M = cfg.microbatches

    def loss_fn(model, mb):
        return cross_entropy(api.forward(model, mb, groups), mb["labels"])

    def grads_of(model, params, batch):
        """(loss, {name: grad}): JAX's value_and_grad (M = 1), or its scan
        over M microbatches (the mean loss, the f32 mean gradient)."""
        if M == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            grads = {name: p.grad for name, p in params.items()}
            for p in params.values():
                p.grad = None
            return loss.detach(), grads
        acc = {name: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
               for name, p in params.items()}

        def fold(name):
            def hook(p):
                acc[name].add_(p.grad.float())
                p.grad = None
            return hook

        hooks = [p.register_post_accumulate_grad_hook(fold(name))
                 for name, p in params.items()]
        try:
            loss_sum = None
            for i in range(M):
                mb = {k: x.reshape(M, x.shape[0] // M, *x.shape[1:])[i]
                      for k, x in batch.items()}
                loss = loss_fn(model, mb)
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            for h in hooks:
                h.remove()
        return loss_sum / M, {name: a.div_(M) for name, a in acc.items()}

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                           Dict]:
        model = state.params
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, grads = grads_of(model, params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = torch.sqrt(sum(
            torch.linalg.vector_norm(g, dtype=torch.float32).square()
            for g in grads.values()))
        adamw_update(params, grads, state.opt, opt_cfg,
                     decay=decayed_names(model))
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, api: ModelAPI,
                      groups: int = 1) -> Callable:
    def prefill_step(model, batch, cache):
        return api.prefill(model, batch, cache, groups)
    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelAPI,
                     groups: int = 1) -> Callable:
    """decode_step(model, tokens, cache) -> (greedy next tokens as int32,
    logits, cache)."""
    def decode_step(model, tokens, cache):
        logits, cache = api.decode(model, tokens, cache, groups)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, logits, cache
    return decode_step
