"""Stock layers with the JAX package's semantics.

Under ``compute_dtype="bfloat16"`` activations are bf16 while every weight
stays f32 (the JAX package's flax ``dtype=`` semantics): these subclasses cast
the weight and bias to the input's type inside ``forward``.  BatchNorm keeps
f32 statistics and, in train mode, updates them by flax's rule.  Dropout
draws its mask from a ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hoisdf_torch.parallel.mesh import all_reduce_sum, world_size


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """On the card a forward without autograd (eval, serving) runs one of
    cuDNN's deterministic algorithms: with its default choice two equal
    forwards differed in the last bits, this being the first operation to
    differ (``scripts/bisect_card_repeat.py``).  A train step keeps cuDNN's
    default choice: its backward is not repeatable anyway, and the
    deterministic forward costs it time."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def run():
            return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x),
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
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x))


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
    the running statistics.  Under a data-parallel group of more than one
    rank the statistics are the global batch's."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if world_size() > 1:
            return self._global_batch_norm(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        for run, batch in ((self.running_mean, mean), (self.running_var, var)):
            run.mul_(1.0 - self.momentum).add_(batch, alpha=self.momentum)
        self.num_batches_tracked.add_(1)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over a data-parallel group: the statistics of the
        global batch, as the JAX package's step sees one global array.  Per
        channel ``[sum, sum of squares]`` and the row count are all-reduced
        in f32 through a differentiable all-reduce (its backward sums the
        gradient of the global sums over the ranks), and the biased variance
        is E[x^2] - E[x]^2.  The sums are taken about the global mean of a
        first, detached all-reduce, so that they do not cancel in f32 where
        the mean outweighs the spread.  ``nn.SyncBatchNorm`` would update
        the running variance with the unbiased estimate, and gloo offers
        only all-reduce and broadcast for CUDA tensors, so this takes
        all-reduces alone."""
        xf = x.float()
        c = x.shape[1]
        rows = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        with torch.no_grad():
            first = torch.cat([xf.sum(dim=(0, 2, 3)), rows])
            dist.all_reduce(first)
            center = (first[:c] / first[c])[None, :, None, None]
        xs = xf - center
        stats = all_reduce_sum(torch.cat([xs.sum(dim=(0, 2, 3)), (xs * xs).sum(dim=(0, 2, 3)),
                                          rows]))
        d = stats[:c] / stats[-1]  # the mean less the center
        var = torch.clamp(stats[c:2 * c] / stats[-1] - d * d, min=0.0)
        with torch.no_grad():
            self._update_running(center.reshape(c) + d, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - d * scale
        return (xs * scale[None, :, None, None] + shift[None, :, None, None]).to(x.dtype)


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
