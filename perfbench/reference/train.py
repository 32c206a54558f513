"""Plain supervised training of the ViT classifier, the reference of the
training cells.

The loss is the mean cross-entropy of a linear head over the final
LayerNorm's CLS row (`vit.forward`), its gradient comes from autograd over
float32 leaves in blocks of rows (each block's mean weighted by its share
of the batch), and the update is AdamW as `torch.optim.AdamW` defines it:
decoupled decay p <- p (1 - lr wd), then p <- p - lr / (1 - b1^t) * m /
(sqrt(v) / sqrt(1 - b2^t) + eps).  `quant` rounds every product's operands
(`vit.fake_quant`, gradients passed straight through): the control.
`rows` keeps only that many rows of each batch: a planted fault.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.vit import linear, vit_forward

B1, B2, EPS = 0.9, 0.999, 1e-8


def loss(params: Dict[str, torch.Tensor], cfg: Dict, pixels: torch.Tensor,
         labels: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    trunk = {k[len("vit."):]: v for k, v in params.items() if k.startswith("vit.")}
    x = vit_forward(trunk, cfg, pixels, quant)[:, 0]
    logits = linear(x, params["classifier.weight"], params["classifier.bias"], quant)
    return F.cross_entropy(logits, labels)


def gradient(params: Dict[str, torch.Tensor], cfg: Dict, batch: Dict, block: int = 32,
             quant: Optional[str] = None, rows: Optional[int] = None
             ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean loss, gradient of it) over the batch, in blocks of rows."""
    pix, lab = batch["pixel_values"], batch["labels"]
    n = len(lab) if rows is None else rows
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    total, acc = 0.0, [torch.zeros_like(p) for p in leaves]
    for s in range(0, n, block):
        e = min(n, s + block)
        with torch.enable_grad():
            part = loss(dict(zip(names, leaves)), cfg, pix[s:e], lab[s:e], quant) * ((e - s) / n)
            grads = torch.autograd.grad(part, leaves)
        total += float(part.detach())
        torch._foreach_add_(acc, list(grads))
    return total, dict(zip(names, acc))


class AdamW:
    """AdamW over float32 copies of `params`; `state` (m, v, t), where given,
    is the optimizer state to go on from: the moments by name and the count
    of steps taken."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 state: Optional[Tuple[Dict, Dict, int]] = None):
        self.params = {k: v.detach().clone().float() for k, v in params.items()}
        if state is None:
            self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
            self.t = 0
        else:
            m, v, self.t = state
            self.m = {k: m[k].detach().clone().float() for k in self.params}
            self.v = {k: v[k].detach().clone().float() for k in self.params}
        self.lr, self.wd = lr, weight_decay

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - B1**self.t, 1 - B2**self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(B1).add_(g, alpha=1 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            denom = self.v[k].sqrt() / bc2**0.5 + EPS
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def steps(opt: AdamW, cfg: Dict, batches: List[Dict], quant: Optional[str] = None,
          rows: Optional[int] = None) -> Dict:
    """One step of `opt` a batch, in order: the loss of each, the first
    step's gradient, and the parameters after the last."""
    losses, first = [], None
    for batch in batches:
        value, grads = gradient(opt.params, cfg, batch, quant=quant, rows=rows)
        losses.append(value)
        first = grads if first is None else first
        opt.step(grads)
    return {"losses": losses, "grad": first, "params": opt.params}


def three_steps(params: Dict[str, torch.Tensor], cfg: Dict, batches: List[Dict], lr: float,
                weight_decay: float, quant: Optional[str] = None, rows: Optional[int] = None
                ) -> Dict:
    """The steps over `batches` from `params` and a fresh optimizer."""
    return steps(AdamW(params, lr, weight_decay), cfg, batches, quant, rows)
