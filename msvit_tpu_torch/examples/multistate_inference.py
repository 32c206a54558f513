"""Multistate inference (counterpart of `examples/multistate_inference.py`):
a dino-vitb8-scale trunk (patch 8 @224, 784 tokens), spectral clustering
(ncut_dim 8, rbf, eigenvalue threshold 0.1), TX/RX pooling.

    python -m msvit_tpu_torch.examples.multistate_inference [--batch 4]
    python -m msvit_tpu_torch.examples.multistate_inference --pretrained DIR
    python -m msvit_tpu_torch.examples.multistate_inference --device cpu

The same flags and defaults as the JAX example, plus ``--device``: it runs
on the CUDA card; ``--device cpu`` is the only way to the CPU (with no card
and no ``--device cpu`` it raises).  Seeded random images by default;
``--dataset`` takes one batch of `data.pipeline.load_image_batches` (a
local image folder; a hub dataset only with network), ``--pretrained``
imports an HF ViT / DINO checkpoint (a file or an HF-layout directory; a
hub id only with network) into the encoder (`import_into_multistate`).
The weights are drawn from seed 1212, the clustering draws from `Rng(0)`.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from msvit_tpu_torch.compat import import_into_multistate, load_state_dict_from
from msvit_tpu_torch.examples.pretrain_synthetic import resolve_device
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
from msvit_tpu_torch.models.multistate import MultiStateViTConfig, MultiStateViTEncoderModel
from msvit_tpu_torch.utils.rng import Rng

SEED = 1212


def default_config(num_sample: int) -> MultiStateViTConfig:
    return MultiStateViTConfig(
        patch_size=8, image_size=224, pregeneration_period=4, generation_period=2,
        clustering=SpectralClusteringConfig(
            ncut_dim=8, num_sample=num_sample, max_clusters=16,
            eigenvalue_threshold=0.1, ncut_dist="rbf"))


def main(argv: Optional[List[str]] = None,
         config: Optional[MultiStateViTConfig] = None) -> dict:
    """Run one forward; returns its outputs.  `config` replaces the model
    config (the tests pass a tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dataset", default=None,
                    help="a local image folder (or a dataset id for datasets.load_dataset)")
    ap.add_argument("--pretrained", default=None,
                    help="checkpoint path, HF-layout dir, or HF hub id (hub needs network)")
    ap.add_argument("--num-sample", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config or default_config(args.num_sample)
    model = MultiStateViTEncoderModel(cfg, generator=torch.Generator().manual_seed(SEED),
                                      device=dev).eval()
    if args.dataset:
        from msvit_tpu_torch.data.pipeline import ImagePipelineConfig, load_image_batches

        loader = load_image_batches(args.dataset, batch_size=args.batch, device=dev,
                                    config=ImagePipelineConfig(image_size=cfg.image_size))
        try:
            pix = next(loader)["pixel_values"]
        finally:
            loader.close()
    else:
        size = cfg.image_size
        pix = torch.randn(args.batch, size, size, cfg.num_channels,
                          generator=torch.Generator().manual_seed(SEED)).to(dev)
    if args.pretrained:
        sd = load_state_dict_from(args.pretrained)
        model.load_state_dict(import_into_multistate(sd, cfg, model.state_dict()))

    with torch.inference_mode():
        out = model(pix, rng=Rng(0))
    print("num_clusters:", int(out["num_clusters"]))
    print("cluster_tokens (TX):", tuple(out["cluster_tokens"].shape))
    print("receiver_to_transmitter_attentions:",
          tuple(out["receiver_to_transmitter_attentions"].shape), flush=True)
    return out


if __name__ == "__main__":
    main()
