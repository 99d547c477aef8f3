"""Per-model Adam with learning-rate schedules (port of
neuralsim_tpu/training/optimizers.py, whose optax chain per model is: optional
gradient clips, ``scale_by_adam(b1, b2, eps)``, ``scale_by_schedule(-lr)``).

The schedule runs on the optimizer's own count of applied steps, not on the
trainer's iteration, exactly as optax does. That count lives on the device so
that a step can be applied or skipped by a device flag without a host sync
(see :meth:`ModelAdam.step`); every schedule type, ``milestones`` and ``linear``
included, is therefore tensor arithmetic on that count.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch import nn


def make_lr_schedule(cfg: Dict[str, Any]) -> Callable[[Any], torch.Tensor]:
    """``count -> learning rate`` (a float32 tensor on the count's device) from
    a scheduler config ``{type, lr, total_steps, decay_target_factor,
    warmup_steps}``; ``count`` is a number or a 0-d tensor. The ``linear`` and
    ``milestones`` types take the annealers' keys (``start_it, stop_it,
    start_val, stop_val``; ``milestones, vals``)."""
    typ = cfg.get("type", "exponential")
    lr0 = float(cfg.get("lr", cfg.get("start_val", 1e-2)))
    total = int(cfg.get("total_steps", cfg.get("num_iters", 10000)))
    warmup = int(cfg.get("warmup_steps", 0))

    def frac(it):
        return torch.clamp(it / max(total, 1), 0.0, 1.0)

    if typ == "constant":
        base = lambda it: torch.full_like(it, lr0)
    elif typ == "exponential":
        target = lr0 * float(cfg.get("decay_target_factor", 0.1))
        base = lambda it: torch.exp(math.log(lr0)
                                    + (math.log(target) - math.log(lr0)) * frac(it))
    elif typ == "cosine":
        target = lr0 * float(cfg.get("decay_target_factor", 0.0))
        base = lambda it: target + 0.5 * (lr0 - target) * (1 + torch.cos(math.pi * frac(it)))
    elif typ == "linear":
        start_it, stop_it = float(cfg.get("start_it", 0)), float(cfg["stop_it"])
        v0, v1 = float(cfg.get("start_val", 0.0)), float(cfg.get("stop_val", 1.0))
        base = lambda it: v0 + (v1 - v0) * torch.clamp(
            (it - start_it) / max(stop_it - start_it, 1e-9), 0.0, 1.0)
    elif typ == "milestones":
        marks = torch.tensor(cfg["milestones"], dtype=torch.float32)
        vals = torch.tensor(cfg["vals"], dtype=torch.float32)
        base = lambda it: vals.to(it.device)[
            torch.clamp(torch.sum(it >= marks.to(it.device)), max=len(vals) - 1)]
    else:
        raise ValueError(typ)

    def sched(count):
        it = torch.as_tensor(count).to(torch.float32)
        lr = base(it)
        if warmup > 0:
            lr = lr * torch.clamp((it + 1) / warmup, 0.0, 1.0)
        return lr

    return sched


class ModelAdam:
    """Adam over one model's parameters, with optax's arithmetic:
    ``mu, nu`` moments, bias correction by the step count, update
    ``-lr(count) * mu_hat / (sqrt(nu_hat) + eps)`` added to the parameter."""

    def __init__(self, params: Sequence[nn.Parameter], cfg: Dict[str, Any]):
        self.params: List[nn.Parameter] = list(params)
        self.b1, self.b2 = (float(b) for b in cfg.get("betas", (0.9, 0.99)))
        self.eps = float(cfg.get("eps", 1e-15))
        self.clip_grad_norm = float(cfg["clip_grad_norm"]) if cfg.get("clip_grad_norm") else None
        self.clip_grad_val = float(cfg["clip_grad_val"]) if cfg.get("clip_grad_val") else None
        self.schedule = make_lr_schedule(cfg)
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)   # applied steps

    def lr(self) -> torch.Tensor:
        """The learning rate the next applied step will use."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], ok: Optional[torch.Tensor] = None) -> None:
        """One Adam step in place. ``ok`` (0-d bool tensor): where it is False
        the parameters, both moments and the count keep their values bit for
        bit. Every new value is selected with ``torch.where(ok, new, old)`` on
        the device, so the host never reads the flag."""
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=self.count.device)
        grads = list(grads)
        if self.clip_grad_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm),
                                self.clip_grad_norm / norm)
            grads = [g * scale for g in grads]
        if self.clip_grad_val is not None:
            grads = [g.clamp(-self.clip_grad_val, self.clip_grad_val) for g in grads]
        lr = self.schedule(self.count)
        count = self.count + 1
        bc1 = 1.0 - self.b1 ** count.to(torch.float32)
        bc2 = 1.0 - self.b2 ** count.to(torch.float32)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu_new = self.b1 * mu + (1.0 - self.b1) * g
            nu_new = self.b2 * nu + (1.0 - self.b2) * (g * g)
            update = -lr * (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps)
            p.copy_(torch.where(ok, p + update, p))
            mu.copy_(torch.where(ok, mu_new, mu))
            nu.copy_(torch.where(ok, nu_new, nu))
        self.count = torch.where(ok, count, self.count)


def make_optimizer(training_cfgs: Dict[str, Dict[str, Any]], params: nn.ModuleDict,
                   default_cfg: Optional[Dict[str, Any]] = None) -> Dict[str, ModelAdam]:
    """One :class:`ModelAdam` per model of ``params`` ({model id: module}),
    each from ``default_cfg`` updated by ``training_cfgs[model id]``."""
    default_cfg = default_cfg or {"lr": 1e-3}
    out = {}
    for model_id, module in params.items():
        cfg = dict(default_cfg)
        cfg.update(training_cfgs.get(model_id, {}))
        out[model_id] = ModelAdam(list(module.parameters()), cfg)
    return out
