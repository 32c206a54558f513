"""Weights and inputs made on the device from the run's seed.

The benchmark makes both and hands the same tensors to the program and to
the reference.  Weights are named as the program's state dicts name them
and drawn from one generator on the card in a few large calls: every
matrix, embedding and bias from one truncated normal (std 0.02, cut at 2
std) over a flat buffer, LayerNorm scales 1 and shifts 0, LayerScale at
the configuration's value.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

STD = 0.02


def stream_seed(seed: int, *path: int) -> int:
    """A 62-bit seed for one named use of the run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, *path]).generate_state(1, np.uint64)[0]
               % 2**62)


def generator(seed: int, *path: int, device="cuda") -> torch.Generator:
    return torch.Generator(device).manual_seed(stream_seed(seed, *path))


def _layer(prefix: str, cfg: Dict) -> List[Tuple[str, tuple, str]]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return [
        (prefix + "layer_scale1", (d,), "scale"),
        (prefix + "layer_scale2", (d,), "scale"),
        (prefix + "norm1.weight", (d,), "one"),
        (prefix + "norm1.bias", (d,), "zero"),
        (prefix + "attention.qkv.weight", (3 * d, d), "normal"),
        (prefix + "attention.qkv.bias", (3 * d,), "normal"),
        (prefix + "attention.output_dense.weight", (d, d), "normal"),
        (prefix + "attention.output_dense.bias", (d,), "normal"),
        (prefix + "norm2.weight", (d,), "one"),
        (prefix + "norm2.bias", (d,), "zero"),
        (prefix + "mlp.fc1.weight", (f, d), "normal"),
        (prefix + "mlp.fc1.bias", (f,), "normal"),
        (prefix + "mlp.fc2.weight", (d, f), "normal"),
        (prefix + "mlp.fc2.bias", (d,), "normal"),
    ]


def layout(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of the configuration's family."""
    d, p, c = cfg["hidden_size"], cfg["patch_size"], cfg["num_channels"]
    patches = (cfg["image_size"] // p) ** 2
    emb = [("embeddings.patch_projection.weight", (d, p * p * c), "normal"),
           ("embeddings.patch_projection.bias", (d,), "normal")]
    layers = range(cfg["num_hidden_layers"])
    if cfg["family"] == "vit":
        out = emb + [("embeddings.position_embeddings", (1, patches + 1, d), "normal"),
                     ("embeddings.cls_token", (1, 1, d), "normal")]
        for i in layers:
            out += _layer(f"encoder.layer.{i}.", cfg)
        return out + [("layernorm.weight", (d,), "one"), ("layernorm.bias", (d,), "zero")]
    if cfg["family"] == "multistate":
        out = emb + [("embeddings.position_embeddings", (1, patches, d), "normal"),
                     ("backbone.transmitter_token", (d,), "normal"),
                     ("backbone.receiver_token", (d,), "normal")]
        for i in layers:
            out += _layer(f"backbone.layer.{i}.", cfg)
        return out
    raise ValueError(f"family {cfg['family']!r}")


def classifier_layout(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """The ViT under `vit.` and a linear head over `num_labels` classes."""
    d, k = cfg["hidden_size"], cfg["num_labels"]
    return [("vit." + n, s, kind) for n, s, kind in layout(cfg)] + [
        ("classifier.weight", (k, d), "normal"), ("classifier.bias", (k,), "zero")]


def make(cfg: Dict, seed: int, device, head: bool = False) -> Dict[str, torch.Tensor]:
    """The configuration's f32 weights from `seed`, on `device` (with `head`,
    the classifier's)."""
    spec = classifier_layout(cfg) if head else layout(cfg)
    sizes = [int(np.prod(s)) for _, s, k in spec if k == "normal"]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, std=STD, a=-2 * STD, b=2 * STD,
                                generator=generator(seed, 1, device=device))
    parts = iter(flat.split(sizes))
    out = {}
    for name, shape, kind in spec:
        if kind == "normal":
            out[name] = next(parts).view(shape)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.full(shape, float(cfg["layerscale_value"]), device=device)
    return out


def u8_images(n: int, size: int, seed: int, *path: int, device="cuda") -> torch.Tensor:
    """n uint8 [size, size, 3] noise images."""
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8, device=device,
                         generator=generator(seed, *path, device=device))


def scenes(n: int, size: int, seed: int, *path: int, prototypes: int = 6,
           device="cuda") -> torch.Tensor:
    """n f32 [size, size, 3] scenes of 8 x 8 patches copied from a few seeded
    prototypes (times 3, plus noise of 0.1), laid out in 4 x 4 blocks of
    patches, so that the patch tokens fall into groups that clustering can
    find (noise images give it one cluster)."""
    g = generator(seed, *path, device=device)
    protos = torch.randn(prototypes, 8, 8, 3, generator=g, device=device) * 3.0
    blocks = torch.randint(0, prototypes, (n, 4, 4), generator=g, device=device)
    p = size // 8
    lab = blocks.repeat_interleave(p // 4, 1).repeat_interleave(p // 4, 2)
    x = protos[lab] + 0.1 * torch.randn(n, p, p, 8, 8, 3, generator=g, device=device)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, size, size, 3)
