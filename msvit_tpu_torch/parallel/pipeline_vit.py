"""The whole classifier over a "stage" mesh (counterpart of
`msvit_tpu/parallel/pipeline_vit.py`).

* The trunk's layers are split into S stages (`split_layers_into_stages`);
  rank s holds its own as an `nn.ModuleList`.
* The embeddings, the final LayerNorm and the head are replicated and run
  outside the pipeline, on every rank: one patch GEMM and one [B, D] GEMM,
  far below the trunk's cost, and no extra stages in the bubble.
* Attention masks travel per microbatch as gpipe's extras.
* `make_pipelined_loss_fn` returns ``loss_fn(model, batch, generator)``,
  which the port's `Trainer` drives unchanged: its loss is the full-batch
  mean, whose gradient the pipeline's backward delivers (the replicated
  parts' whole on every rank, the stage's layers' on their rank).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from msvit_tpu_torch.models.base.config import BaseViTConfig
from msvit_tpu_torch.models.base.model import BaseViTLayer, Linear
from msvit_tpu_torch.models.base.norm import LayerNorm
from msvit_tpu_torch.models.base.vit import ViTEmbeddings, ViTForImageClassification
from msvit_tpu_torch.parallel.pipeline import (
    gpipe, make_layer_stage_fn, split_layers_into_stages)


class PipelinedViTClassifier(nn.Module):
    """One stage's part of `ViTForImageClassification`: the replicated
    embeddings, LayerNorm and head, and layers ``[stage*L/S, (stage+1)*L/S)``
    as ``layer``.  Weights are drawn from `generator` as the full model
    would and then cut (`init_pipelined_classifier`), or loaded with
    `pipeline_params_from_full`."""

    def __init__(self, config: BaseViTConfig, num_labels: int, num_stages: int,
                 *, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if config.num_hidden_layers % num_stages:
            raise ValueError(f"{config.num_hidden_layers} layers not divisible by "
                             f"{num_stages} stages")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.embeddings = ViTEmbeddings(config, True, generator)
        self.layer = nn.ModuleList(BaseViTLayer(config, generator)
                                   for _ in range(config.num_hidden_layers // num_stages))
        policy = config.policy
        self.layernorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   policy.output, policy.param)
        self.classifier = Linear(config.hidden_size, num_labels, True, config, generator)
        if device is not None:
            self.to(device)


def pipeline_params_from_full(state_dict: Mapping[str, torch.Tensor], num_stages: int,
                              stage: int) -> Dict[str, torch.Tensor]:
    """A `ViTForImageClassification` state dict -> stage `stage`'s
    `PipelinedViTClassifier` state dict."""
    enc = {k[len("vit.encoder."):]: v for k, v in state_dict.items()
           if k.startswith("vit.encoder.")}
    out = {f"layer.{k}": v for k, v in split_layers_into_stages(enc, num_stages)[stage].items()}
    for k, v in state_dict.items():
        if k.startswith(("vit.embeddings.", "vit.layernorm.")):
            out[k[len("vit."):]] = v
        elif k.startswith("classifier."):
            out[k] = v
    return out


def shard_pipeline_params(mesh: DeviceMesh, state_dict: Mapping[str, torch.Tensor],
                          num_stages: int) -> Dict[str, torch.Tensor]:
    """This rank's stage of a full state dict (its index on "stage")."""
    return pipeline_params_from_full(state_dict, num_stages, mesh.get_local_rank("stage"))


def init_pipelined_classifier(cfg: BaseViTConfig, num_labels: int, num_stages: int,
                              mesh: DeviceMesh, generator: Optional[torch.Generator] = None,
                              device=None) -> PipelinedViTClassifier:
    """This rank's stage of the sequential model drawn from `generator`
    (the same weights as `ViTForImageClassification(cfg, generator=...)`)."""
    full = ViTForImageClassification(cfg, num_labels, generator=generator)
    model = PipelinedViTClassifier(cfg, num_labels, num_stages)
    model.load_state_dict(shard_pipeline_params(mesh, full.state_dict(), num_stages))
    return model.to(device) if device is not None else model


def make_pipelined_classifier_apply(cfg: BaseViTConfig, num_labels: int, num_stages: int,
                                    num_microbatches: int, mesh: DeviceMesh):
    """Build ``apply(model, pixel_values, attention_mask=None) -> logits``
    (f32, whole on every rank): pixel_values ``[B, H, W, C]`` with B
    divisible by num_microbatches; attention_mask ``[B, 1|H, N, N]``."""

    def apply(model: PipelinedViTClassifier, pixel_values: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, m = pixel_values.shape[0], num_microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        x = model.embeddings(pixel_values)
        n, d = x.shape[1], x.shape[2]
        extras = None
        if attention_mask is not None:
            extras = {"attention_mask": attention_mask.reshape(
                (m, b // m) + tuple(attention_mask.shape[1:]))}
        run = gpipe(make_layer_stage_fn(model.layer), num_stages, m, mesh)
        h = run(x.reshape(m, b // m, n, d), extras).reshape(b, n, d)
        return model.classifier(model.layernorm(h)[:, 0]).float()

    return apply


def make_pipelined_loss_fn(cfg: BaseViTConfig, num_labels: int, num_stages: int,
                           num_microbatches: int, mesh: DeviceMesh):
    """`Trainer`-compatible CE loss over the pipelined classifier:
    ``loss_fn(model, batch, generator) -> (scalar, {"accuracy"})`` with
    batch ``{"pixel_values": [B, H, W, C], "labels": [B]}``."""
    apply = make_pipelined_classifier_apply(cfg, num_labels, num_stages,
                                            num_microbatches, mesh)

    def loss_fn(model, batch: Dict[str, Any], generator=None):
        logits = apply(model, batch["pixel_values"])
        labels = batch["labels"]
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"accuracy": acc}

    return loss_fn
