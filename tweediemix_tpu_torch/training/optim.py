"""The trainer's optimizers with optax's numerics: AdamW, and the global-norm
clip with gradient accumulation around it.

``AdamW`` is ``optax.adamw`` (``scale_by_adam``, then
``add_decayed_weights``, then ``scale_by_learning_rate``): the moments are
updated, bias-corrected with the count after the update, the decay is added
to the Adam direction and the sum is scaled by the learning rate of the
count before the update, ``p - lr·(m̂/(√v̂+eps) + wd·p)``. The learning rate
may be a float or a function of that count (``lr_schedules``).

``FullOptimizer`` is ``optax.chain(clip_by_global_norm, adam)`` under
``optax.MultiSteps``: the micro-step gradients are averaged as MultiSteps
averages them, and every k-th call the average is clipped (scaled by
max_norm / norm only when the norm is not below max_norm, not
``clip_grad_norm_``'s max_norm / (norm + 1e-6)) and handed to the inner
optimizer. It never changes a gradient in place, so a caller that keeps
the step's gradients can read them after it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


class AdamW(torch.optim.Optimizer):
    """``optax.adamw`` over fp32 moments (module docstring). A parameter
    whose ``.grad`` is None is skipped."""

    def __init__(self, params, lr=1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))

    def init_moments(self, p: torch.Tensor) -> Dict:
        return dict(mu=torch.zeros_like(p, dtype=torch.float32),
                    nu=torch.zeros_like(p, dtype=torch.float32))

    def read_moments(self, st: Dict, p: torch.Tensor):
        return st["mu"], st["nu"]

    def write_moments(self, st: Dict, mu: torch.Tensor, nu: torch.Tensor) -> None:
        st["mu"], st["nu"] = mu, nu

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(step=0, **self.init_moments(p))
                count = st["step"]
                lr = group["lr"](count) if callable(group["lr"]) else group["lr"]
                g = p.grad.float()
                mu, nu = self.read_moments(st, p)
                mu = (1.0 - b1) * g + b1 * mu
                nu = (1.0 - b2) * (g * g) + b2 * nu
                direction = (mu / (1.0 - b1 ** (count + 1))) / (
                    torch.sqrt(nu / (1.0 - b2 ** (count + 1))) + eps)
                update = -lr * (direction + wd * p.float())
                p.copy_((p.float() + update).to(p.dtype))
                self.write_moments(st, mu, nu)
                st["step"] = count + 1


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (fp32)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients unchanged while their
    global norm is below ``max_norm``, else each scaled by max_norm / norm."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return [g * scale.to(g.dtype) for g in grads]


class FullOptimizer:
    """Clip, then ``inner``, every ``accumulation_steps``-th call of
    ``step`` on the running mean of the gradients since the last update
    (module docstring). A parameter without a gradient counts as a zero
    gradient, as a JAX gradient of an unused leaf is zero: its moments
    decay and its weight decay applies."""

    def __init__(self, params: Sequence[torch.nn.Parameter], inner: torch.optim.Optimizer,
                 max_grad_norm: float, accumulation_steps: int = 1):
        self.params = list(params)
        self.inner = inner
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = accumulation_steps
        self.mini_step = 0
        self.acc: List[torch.Tensor] = []

    @torch.no_grad()
    def step(self) -> bool:
        """Take this micro step's gradients; True where the parameters
        were updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.accumulation_steps > 1:
            if not self.acc:
                self.acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            self.acc = [a + (g.to(a.dtype) - a) / (n + 1) for a, g in zip(self.acc, grads)]
            self.mini_step += 1
            if self.mini_step < self.accumulation_steps:
                return False
            grads, self.acc, self.mini_step = self.acc, [], 0
        for p, g in zip(self.params, clip_by_global_norm(grads, self.max_grad_norm)):
            p.grad = g
        self.inner.step()
        for p in self.params:  # the clipped copies are spent
            p.grad = None
        return True

    def state_dict(self) -> Dict:
        return dict(inner=[self.inner.state[p] for p in self.params], acc=self.acc,
                    mini_step=self.mini_step)

    def load_state_dict(self, state: Dict) -> None:
        for p, st in zip(self.params, state["inner"]):
            self.inner.state[p] = {k: v.to(p.device) if torch.is_tensor(v) else v
                                   for k, v in st.items()}
        self.acc = [a.to(p.device) for a, p in zip(state["acc"], self.params)]
        self.mini_step = state["mini_step"]
