"""Multistate fine-tuning (counterpart of `examples/train_multistate.py`):
the trunk stays frozen, and only the transmitter/receiver tokens plus a
linear classifier over the occupancy-pooled TX tokens train; the gradient
still flows through every layer.

    python -m msvit_tpu_torch.examples.train_multistate [--steps 10] [--batch 8]
    python -m msvit_tpu_torch.examples.train_multistate --device cpu
    python -m msvit_tpu_torch.examples.train_multistate --preset b8 --ckpt runs/synthetic/pretrain_b8/ckpt

The same flags and defaults as the JAX example (patch 16 @224: 196 patch
tokens + 2 x 16 TX/RX slots; spectral clustering at layers 4, 6, 8 and
10).  It runs on the CUDA card; ``--device cpu`` is the only way to the CPU
(with no card and no ``--device cpu`` it raises).  ``--dataset`` needs the
hub dataset loader and ``--pretrained`` the HF weight import, not ported
yet: both raise.  The images and labels are seeded random ones.

``--ckpt <dir>`` restores a `pretrain_synthetic` checkpoint and wires its
trunk into the encoder (`transfer_base_to_multistate`) before fine-tuning,
as the JAX package's `train_multistate_synthetic.py` does; ``--preset``
gives the encoder that checkpoint's geometry (`pretrain_synthetic.PRESETS`)
and ``--qk-norm`` its q/k norms, when it was trained with them.

The trainable set is JAX's: every parameter with a name part
`transmitter_token`, `receiver_token` or `classifier`.  The frozen
parameters are also set ``requires_grad_(False)``, which saves their
gradients and changes no update (the optimizer leaves them alone either
way).  Step s draws from a generator seeded with `fold_in(1212, s)`, which
seeds the step's clustering `Rng` and its dropout.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from msvit_tpu_torch.compat.family import transfer_base_to_multistate
from msvit_tpu_torch.examples.pretrain_synthetic import PRESETS
from msvit_tpu_torch.models.clustering import SpectralClusteringConfig
from msvit_tpu_torch.models.multistate import (
    MultiStateViTConfig,
    MultiStateViTForImageClassification,
)
from msvit_tpu_torch.train import Trainer, make_optimizer, restore_checkpoint
from msvit_tpu_torch.utils.rng import Rng, draw_seed, fold_in

SEED = 1212
TRAINABLE = ("transmitter_token", "receiver_token", "classifier")


def default_config(num_sample: int, preset: Optional[str] = None,
                   qk_norm: bool = False) -> MultiStateViTConfig:
    """The JAX example's model config (patch 16 @224), or a pretrain
    preset's geometry under the same clustering."""
    geom = PRESETS[preset] if preset else dict(patch_size=16, image_size=224)
    return MultiStateViTConfig(
        **geom, qk_norm=qk_norm, pregeneration_period=4, generation_period=2,
        clustering=SpectralClusteringConfig(
            ncut_dim=8, num_sample=num_sample, max_clusters=16,
            eigenvalue_threshold=0.1, ncut_dist="rbf"))


def trainable(path) -> bool:
    return any(n in TRAINABLE for n in path)


def loss_fn(model, batch, generator):
    pix, labels = batch
    out = model(pix, labels, rng=Rng(draw_seed(generator)), generator=generator)
    acc = (out["logits"].argmax(-1) == labels).float().mean()
    return out["loss"], {"accuracy": acc}


def load_pretrained_trunk(model: MultiStateViTForImageClassification,
                          ckpt_dir: str) -> None:
    """Restore the newest `pretrain_synthetic` checkpoint under `ckpt_dir`
    and copy its trunk into `model.encoder` (TX/RX tokens from the CLS
    token; the classifier stays as initialised)."""
    params = restore_checkpoint(ckpt_dir)["params"]
    base = {k[len("vit."):]: v for k, v in params.items() if k.startswith("vit.")}
    cfg = model.encoder.config
    model.encoder.load_state_dict(transfer_base_to_multistate(
        base, model.encoder.state_dict(), cfg.num_hidden_layers))


def main(argv: Optional[List[str]] = None,
         config: Optional[MultiStateViTConfig] = None) -> List[float]:
    """Run the fine-tune; returns the per-step losses.  `config`, when
    given, replaces the model config (the tests pass a tiny one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--labels", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--num-sample", type=int, default=256)
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--ckpt", default=None,
                    help="pretrain_synthetic checkpoint dir to start the trunk from")
    ap.add_argument("--preset", default=None, choices=sorted(PRESETS),
                    help="the checkpoint's geometry (default: patch 16 @224)")
    ap.add_argument("--qk-norm", action="store_true",
                    help="the trunk was pretrained with config.qk_norm")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.dataset:
        raise NotImplementedError(
            "--dataset needs the hub dataset loader (ROADMAP.md queue 1, item 10: "
            "data/pipeline.py::load_image_batches), not ported yet")
    if args.pretrained:
        raise NotImplementedError(
            "--pretrained needs the HF weight import (ROADMAP.md queue 1, item 9: "
            "compat/hf_import.py), not ported yet")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card "
                           "(pass --device cpu for the CPU)")
    dev = torch.device(args.device)

    cfg = config or default_config(args.num_sample, args.preset, args.qk_norm)
    g = torch.Generator().manual_seed(SEED)
    pix = torch.randn(args.batch, cfg.image_size, cfg.image_size, cfg.num_channels,
                      generator=g).to(dev)
    labels = torch.randint(0, args.labels, (args.batch,), generator=g).to(dev)
    model = MultiStateViTForImageClassification(
        cfg, args.labels, generator=torch.Generator().manual_seed(SEED), device=dev)
    if args.ckpt:
        load_pretrained_trunk(model, args.ckpt)
        print(f"restored trunk from {args.ckpt}", flush=True)
    model.train()
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(tuple(name.split("."))))

    trainer = Trainer(loss_fn, make_optimizer(args.lr, trainable=trainable), model,
                      log_every=1)
    losses = []
    for step in range(args.steps):
        gen = torch.Generator().manual_seed(fold_in(SEED, step))
        loss, aux = trainer.step_fn(trainer.model, trainer.opt_state, (pix, labels), gen)
        losses.append(float(loss))
        print(f"step {step:3d}  loss {losses[-1]:8.4f}  acc {float(aux['accuracy']):.3f}",
              flush=True)
    first, last = losses[0], losses[-1]
    print(f"loss {first:.4f} -> {last:.4f} ({'down' if last < first else 'UP'})", flush=True)
    return losses


if __name__ == "__main__":
    main()
