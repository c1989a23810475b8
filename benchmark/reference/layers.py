"""Stock layers of the reference (a frozen copy of the port's, one process).

Under ``compute_dtype="bfloat16"`` activations are bf16 while every weight
stays f32 (the JAX package's flax ``dtype=`` semantics): these subclasses cast
the weight and bias to the input's type inside ``forward``.  BatchNorm keeps
f32 statistics and, in train mode, updates them by flax's rule.  Dropout
draws its mask from a ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


def rounded(layer: nn.Module, x: torch.Tensor, w: torch.Tensor):
    """``(x, w)`` as the layer's product takes them: unchanged, or both
    rounded by the ``round_operands`` function that :func:`set_operand_rounding`
    gave the layer (the controls' lower precision)."""
    fn = getattr(layer, "round_operands", None)
    return (x, w) if fn is None else (fn(x), fn(w))


def set_operand_rounding(model: nn.Module, fn) -> nn.Module:
    """Give every product layer of ``model`` (convolutions, linear layers,
    attention's packed projection) the operand rounding ``fn`` (None: off)."""
    for m in model.modules():
        if hasattr(m, "round_operands"):
            m.round_operands = fn
    return model


class Conv2d(nn.Conv2d):
    round_operands = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = rounded(self, x, self.weight.to(x.dtype))
        return self._conv_forward(x, w, _cast(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    round_operands = None

    """On the card a forward without autograd (eval, serving) runs one of
    cuDNN's deterministic algorithms: with its default choice two equal
    forwards differed in the last bits, this being the first operation to
    differ (``scripts/bisect_card_repeat.py``).  A train step keeps cuDNN's
    default choice: its backward is not repeatable anyway, and the
    deterministic forward costs it time."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def run():
            xr, w = rounded(self, x, self.weight.to(x.dtype))
            return F.conv_transpose2d(xr, w, _cast(self.bias, x),
                                      self.stride, self.padding, self.output_padding,
                                      self.groups, self.dilation)

        cudnn = torch.backends.cudnn
        if not x.is_cuda or torch.is_grad_enabled() or cudnn.deterministic:
            return run()
        cudnn.deterministic = True
        try:
            return run()
        finally:
            cudnn.deterministic = False


class Linear(nn.Linear):
    round_operands = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xr, w = rounded(self, x, self.weight.to(x.dtype))
        return F.linear(xr, w, _cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with flax's default epsilon (1e-6), as the JAX package uses."""

    def __init__(self, d: int):
        super().__init__(d, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) whose train mode follows
    flax ``nn.BatchNorm(momentum=0.9)``: normalise with the batch mean and
    biased variance, and update ``running = 0.9 * running + 0.1 * batch`` with
    the *biased* batch variance (torch would take the unbiased one, N/(N-1)
    larger).  Statistics stay f32 under bf16 activations.  Eval mode runs on
    the running statistics."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        for run, batch in ((self.running_mean, mean), (self.running_var, var)):
            run.mul_(1.0 - self.momentum).add_(batch, alpha=self.momentum)
        self.num_batches_tracked.add_(1)


class Dropout(nn.Module):
    """Dropout with rate ``p`` in train mode, an identity otherwise: keep each
    element with probability 1 - p and scale it by 1 / (1 - p), as flax's
    ``nn.Dropout``.  The mask comes from ``generator`` (on x's device) when
    one is given, so a seeded generator repeats it."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))
