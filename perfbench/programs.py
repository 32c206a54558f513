"""The system under test, built through the public API of `msvit_tpu_torch`.

Each function turns a configuration file and the benchmark's weights into
the program's own objects: configs, models with those weights loaded, int8
parameters and calibrated scales, and the functions a loop calls in its
window.  Nothing here computes what is judged; it only calls the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


def _trunk_fields(cfg: Dict) -> Dict:
    return dict(
        hidden_size=cfg["hidden_size"], num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        mlp_ratio=cfg["intermediate_size"] / cfg["hidden_size"],
        hidden_act=cfg["hidden_act"], layer_norm_eps=cfg["layer_norm_eps"],
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        num_channels=cfg["num_channels"], qkv_bias=cfg["qkv_bias"],
        layerscale_value=cfg["layerscale_value"])


def vit_config(cfg: Dict):
    from msvit_tpu_torch.models.base import BaseViTConfig

    return BaseViTConfig(**_trunk_fields(cfg))


def multistate_config(cfg: Dict):
    from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
    from msvit_tpu_torch.models.multistate import MultiStateViTConfig

    cl = cfg["clustering"]
    clustering = SpectralClusteringConfig(
        ncut_dim=cl["ncut_dim"], num_sample=cl["num_sample"],
        max_clusters=cl["max_clusters"], pool_batch=cl["pool_batch"],
        ncut_dist=cl["ncut_dist"], eigenvalue_threshold=cl["eigenvalue_threshold"],
        affinity_focal_gamma=cl["affinity_focal_gamma"], kmeans_iters=cl["kmeans_iters"],
        eig_method=cl["eig_method"], eig_iters=cl["eig_iters"],
        matmul_dtype=cl["matmul_dtype"], late_num_sample=cl["late_num_sample"])
    return MultiStateViTConfig(
        **_trunk_fields(cfg), pregeneration_period=cfg["pregeneration_period"],
        generation_period=cfg["generation_period"],
        attention_mask_inf=cfg["attention_mask_inf"], clustering=clustering)


def _loaded(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> torch.nn.Module:
    model.load_state_dict(sd, strict=True)
    return model.eval()


def vit_model(cfg: Dict, sd: Dict[str, torch.Tensor], dev) -> torch.nn.Module:
    """The bf16 ViT (f32 parameters) with the benchmark's weights."""
    from msvit_tpu_torch.models.base import ViTModel

    with torch.device(dev):
        model = ViTModel(vit_config(cfg), generator=torch.Generator(dev).manual_seed(0))
    return _loaded(model, sd)


def multistate_model(cfg: Dict, sd: Dict[str, torch.Tensor], dev) -> torch.nn.Module:
    from msvit_tpu_torch.models.multistate import MultiStateViTEncoderModel

    with torch.device(dev):
        model = MultiStateViTEncoderModel(
            multistate_config(cfg), generator=torch.Generator(dev).manual_seed(0))
    return _loaded(model, sd)


def wire_pixels(u8: np.ndarray, dev) -> torch.Tensor:
    """uint8 wire images -> f32 in [-1, 1] on the device, as the serving
    example normalizes them."""
    return torch.from_numpy(u8).to(dev).float() / 127.5 - 1.0


def vit_serving(cfg: Dict, sd: Dict[str, torch.Tensor], calib_u8: np.ndarray,
                dev) -> Tuple[Callable, Callable]:
    """(int8_fn, bf16_fn): uint8 [B, S, S, 3] -> the CLS embedding [B, D] f32
    on the device.  The int8 forward runs with activation scales calibrated
    on `calib_u8`, as `examples/serve_vit.py` builds it."""
    from msvit_tpu_torch.models.base.quantized import (
        calibrate_act_scales, quantize_vit_params, quantized_vit_apply)

    model = vit_model(cfg, sd, dev)
    pcfg = model.config
    qparams = quantize_vit_params(model)
    scales = calibrate_act_scales(qparams, pcfg, wire_pixels(calib_u8, dev))

    def int8_fn(u8):
        with torch.inference_mode():
            return quantized_vit_apply(qparams, pcfg, wire_pixels(u8, dev),
                                       act_scales=scales)[:, 0].float()

    def bf16_fn(u8):
        with torch.inference_mode():
            return model(wire_pixels(u8, dev))["last_hidden_state"][:, 0].float()

    return int8_fn, bf16_fn


def multistate_forward(cfg: Dict, sd: Dict[str, torch.Tensor], precision: str,
                       calib: torch.Tensor, dev) -> Callable:
    """fn(pixels [B, S, S, 3] f32, clustering seed) -> the encoder's outputs:
    the int8 forward (`quantized_multistate_apply`, scales calibrated on
    `calib`) or the bf16 eval forward of the model."""
    from msvit_tpu_torch.models.multistate import (
        calibrate_multistate_act_scales, quantize_multistate_params,
        quantized_multistate_apply)

    model = multistate_model(cfg, sd, dev)
    pcfg = model.config
    if precision == "bf16":
        def bf16_fn(pix, seed):
            with torch.inference_mode():
                return model(pix, rng=seed)

        return bf16_fn
    qparams = quantize_multistate_params(model)
    scales = calibrate_multistate_act_scales(qparams, pcfg, calib, 0)
    del model

    def int8_fn(pix, seed):
        return quantized_multistate_apply(qparams, pcfg, pix, seed, act_scales=scales)

    return int8_fn


class ClusteringRecorder:
    """Keeps each clustering event of the latest forward of every slot (the
    pool batch a loop sets with `begin`): its parents, features, key,
    bound, child ids and children per parent, as the program computed them.
    It wraps the clustering call that the multistate encoder's re-clustering
    step makes, and only holds references: the forward computes nothing
    more.  `close` puts the program's call back."""

    def __init__(self):
        from msvit_tpu_torch.models.multistate import model

        self._module, self._inner = model, model.cluster
        self.events = {}
        self._slot = None
        model.cluster = self._cluster

    def begin(self, slot) -> None:
        self._slot = slot
        self.events[slot] = []

    def _cluster(self, config, parent_indices, x, key, max_parents=None):
        child, n_children = self._inner(config, parent_indices, x, key,
                                        max_parents=max_parents)
        if self._slot is not None:
            self.events[self._slot].append({
                "parents": parent_indices, "x": x, "key": key.seed,
                "max_parents": max_parents, "child": child, "n_children": n_children})
        return child, n_children

    def close(self) -> None:
        self._module.cluster = self._inner


def vit_trainer(cfg: Dict, sd: Dict[str, torch.Tensor], tr: Dict, dev):
    """A `Trainer` over the ViT classifier with the benchmark's weights:
    mean cross-entropy, `make_optimizer` (AdamW) at the traffic's learning
    rate and weight decay, non-finite steps skipped (`monitor`), the loss
    read every `log_every` steps, no checkpoint."""
    import torch.nn.functional as F

    from msvit_tpu_torch.models.base import ViTForImageClassification
    from msvit_tpu_torch.train import Trainer, make_optimizer

    with torch.device(dev):
        model = ViTForImageClassification(vit_config(cfg), cfg["num_labels"],
                                          generator=torch.Generator(dev).manual_seed(0))
    model.load_state_dict(sd, strict=True)
    model.train()

    def ce_loss(model, batch, generator):
        logits = model(batch["pixel_values"], generator=generator)
        return F.cross_entropy(logits, batch["labels"]), {}

    opt = make_optimizer(tr["learning_rate"], weight_decay=tr["weight_decay"])
    return Trainer(ce_loss, opt, model, log_every=tr["log_every"], monitor=True)


def adam_moments(trainer) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Parameter name -> AdamW's first and second moments, from the
    trainer's state (zero for a parameter the optimizer holds no state
    for).  The tensors are the optimizer's own, updated in place."""
    state = trainer.opt_state.adamw.state

    def moment(key):
        return {n: state[p][key] if p in state else torch.zeros_like(p)
                for n, p in trainer.model.named_parameters()}

    return moment("exp_avg"), moment("exp_avg_sq")


def applied_steps(trainer) -> int:
    """The optimizer's count of the steps it applied (a monitored step that
    met a non-finite gradient is not applied)."""
    return int(trainer.opt_state.count)
