"""Optimiser from the OPTIMIZER config dict (port of m3d/train/optim.py).

``Optimizer`` is an explicit update over a name -> parameter dict that
computes optax's transform chain in JAX's order:

1. L2 weight decay ``g + WEIGHT_DECAY * w`` on every leaf except BatchNorm
   (``decay_mask``), or the size-normalised ``g + WEIGHT_DECAY / size(w) *
   w`` with WEIGHT_DECAY_SIZE_NORMALIZED;
2. per-leaf ``clipnorm`` (Keras), then the global GRADIENT_CLIP_NORM;
3. SGD with momentum (optax ``trace``, nesterov optional), Adam or
   Adadelta, scaled by -learning_rate;
4. the Keras iteration decay ``1 / (1 + decay * count)``, after the
   momentum.

Frozen leaves (``freeze_predicate``) get no update and take no part in the
global norm, as optax's ``multi_transform`` with ``set_to_zero`` gives. The
learning rate is plain state: ``set_learning_rate`` changes it between
steps. Also: ``apply_constraints`` (Keras MaxNorm after the step),
``ReduceLROnPlateau`` and ``EarlyStopping``.
"""

from __future__ import annotations

import numpy as np
import torch


def _normalize_params(p: dict | None) -> dict:
    p = dict(p or {})
    if "lr" in p and "learning_rate" not in p:
        p["learning_rate"] = p.pop("lr")
    if "beta1" in p:
        p["beta_1"] = p.pop("beta1")
    if "beta2" in p:
        p["beta_2"] = p.pop("beta2")
    return p


def _segments(name: str):
    return name.replace("/", ".").split(".")


def decay_mask(name: str) -> bool:
    """True where weight decay applies: every leaf except BatchNorm's (a
    path segment containing "bn")."""
    return not any("bn" in seg.lower() for seg in _segments(name))


# OPTIMIZER.parameters keys each optimizer consumes; others are warned of.
_KNOWN_PARAMS = {
    "sgd": {"learning_rate", "momentum", "nesterov", "clipnorm", "decay"},
    "adadelta": {"learning_rate", "rho", "epsilon", "clipnorm", "decay"},
    "adam": {"learning_rate", "beta_1", "beta_2", "epsilon", "clipnorm",
             "decay"},
    "adamw": {"learning_rate", "beta_1", "beta_2", "epsilon", "clipnorm",
              "decay"},
}


class Optimizer:
    """The transform chain over ``params`` (name -> tensor with .grad).
    ``step()`` reads each trainable leaf's ``.grad`` (None counts as 0) and
    updates the leaf in place."""

    def __init__(self, config, params: dict, freeze_predicate=None):
        spec = getattr(config, "OPTIMIZER", {"name": "SGD", "parameters": {}})
        self.name = str(spec.get("name", "SGD")).lower()
        p = _normalize_params(spec.get("parameters"))
        if self.name not in _KNOWN_PARAMS:
            raise ValueError(f"unsupported optimizer: {spec}")
        unknown = set(p) - _KNOWN_PARAMS[self.name]
        if unknown:
            print(f"[Optimizer] WARNING: OPTIMIZER.parameters keys "
                  f"{sorted(unknown)} are not supported for {self.name!r} "
                  f"and are ignored")
        lr = p.get("learning_rate", 1.0 if self.name == "adadelta" else 0.01)
        self.lr = float(np.float32(lr))   # optax keeps it as a float32
        self.momentum = float(p.get("momentum", 0.9))
        self.nesterov = bool(p.get("nesterov", False))
        self.rho = float(p.get("rho", 0.95))
        self.b1 = float(p.get("beta_1", 0.9))
        self.b2 = float(p.get("beta_2", 0.999))
        self.eps = float(p.get("epsilon", 1e-7 if self.name == "adadelta"
                               else 1e-8))
        self.clipnorm = float(p.get("clipnorm", 0.0) or 0.0)
        self.decay = float(p.get("decay", 0.0) or 0.0)
        self.wd = float(getattr(config, "WEIGHT_DECAY", 0.0))
        self.wd_size = bool(getattr(config, "WEIGHT_DECAY_SIZE_NORMALIZED",
                                    False))
        self.global_clip = float(getattr(config, "GRADIENT_CLIP_NORM", 0.0)
                                 or 0.0)
        self.params = {k: v for k, v in params.items()
                       if freeze_predicate is None or not freeze_predicate(k)}
        n_state = 1 if self.name == "sgd" else 2
        self.state = {k: [torch.zeros_like(v) for _ in range(n_state)]
                      for k, v in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self):
        grads = {}
        for k, w in self.params.items():
            g = w.grad.float() if w.grad is not None else torch.zeros_like(w)
            if self.wd > 0 and decay_mask(k):
                scale = self.wd / w.numel() if self.wd_size else self.wd
                g = g + scale * w
            if self.clipnorm > 0:
                n = torch.sqrt(torch.sum(g * g))
                g = g * torch.clamp(self.clipnorm / n.clamp_min(1e-12),
                                    max=1.0)
            grads[k] = g
        if self.global_clip > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            clip = norm >= self.global_clip
            grads = {k: torch.where(clip, g / norm * self.global_clip, g)
                     for k, g in grads.items()}
        self.count += 1
        sched = 1.0 / (1.0 + self.decay * (self.count - 1)) \
            if self.decay > 0 else 1.0
        for k, g in grads.items():
            u = self._direction(g, self.state[k])
            self.params[k].add_(u * (-self.lr) * sched)

    def _direction(self, g, st):
        if self.name == "sgd":
            st[0].mul_(self.momentum).add_(g)
            return g + self.momentum * st[0] if self.nesterov else st[0]
        if self.name == "adadelta":
            e_g, e_x = st
            e_g.mul_(self.rho).add_((1 - self.rho) * g * g)
            u = torch.sqrt(e_x + self.eps) / torch.sqrt(e_g + self.eps) * g
            e_x.mul_(self.rho).add_((1 - self.rho) * u * u)
            return u
        mu, nu = st                                     # adam / adamw
        mu.mul_(self.b1).add_((1 - self.b1) * g)
        nu.mul_(self.b2).add_((1 - self.b2) * g * g)
        mu_hat = mu / (1 - self.b1 ** self.count)
        nu_hat = nu / (1 - self.b2 ** self.count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps)


def get_learning_rate(opt: Optimizer) -> float:
    return opt.lr


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    """Change the base learning rate between steps (no rebuild)."""
    opt.lr = float(np.float32(lr))
    return opt


# Keras MaxNorm constraints, a projection after each step: the norm is over
# each output unit's input weights (torch layout [out, in]: dim 1).
_MAXNORM = {"mrcnn_class_logits": 2.0, "mrcnn_bbox_fc": 1.0}


@torch.no_grad()
def apply_constraints(params: dict, frozen_predicate=None):
    """Project the Dense kernels of ``_MAXNORM`` to their max norms, in
    place; frozen leaves are left alone (Keras constrains only weights it
    updates)."""
    for name, w in params.items():
        segs = _segments(name)
        if segs[-1] != "weight" or (frozen_predicate is not None
                                    and frozen_predicate(name)):
            continue
        for module, max_norm in _MAXNORM.items():
            if module in segs:
                norm = torch.sqrt((w * w).sum(1, keepdim=True))
                w.mul_(torch.clamp(max_norm / norm.clamp_min(1e-7), max=1.0))
    return params


class ReduceLROnPlateau:
    def __init__(self, factor=0.5, patience=3, min_lr=1e-6, mode="min"):
        self.factor, self.patience, self.min_lr = factor, patience, min_lr
        self.mode = mode
        self.best = np.inf if mode == "min" else -np.inf
        self.wait = 0

    def update(self, metric, lr):
        improved = (metric < self.best) if self.mode == "min" \
            else (metric > self.best)
        if improved:
            self.best, self.wait = metric, 0
            return lr
        self.wait += 1
        if self.wait >= self.patience:
            self.wait = 0
            new_lr = max(self.min_lr, lr * self.factor)
            if new_lr < lr:
                print(f"[ReduceLROnPlateau] lr {lr:.2e} -> {new_lr:.2e}")
            return new_lr
        return lr


class EarlyStopping:
    def __init__(self, patience=10, mode="min", min_delta=0.0):
        self.patience, self.mode, self.min_delta = patience, mode, min_delta
        self.best = np.inf if mode == "min" else -np.inf
        self.wait = 0
        self.stopped = False

    def update(self, metric):
        improved = (metric < self.best - self.min_delta if self.mode == "min"
                    else metric > self.best + self.min_delta)
        if improved:
            self.best, self.wait = metric, 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped
