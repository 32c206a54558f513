"""Predictive encoder (counterpart of `msvit_tpu/models/predictive/model.py`).

* A continuous glimpse tokenizer: the dof vector of each glimpse (its
  translation and scale) places a P x P lattice in the image, sampled
  bicubically with border padding (`ops/grid_sample.py::
  grid_sample_separable`), encoded by a 5-layer SiLU conv stack to 1024
  features and a Linear to D, standardised over (batch, tokens)
  (BatchNorm without affine or running state).
* A linear position encoder (dof -> D) and decoder (D -> dof, a sigmoid
  and the config's scale; optionally the component of a latent orthogonal
  to the decoder's row space) and a mirror decoder of transposed convs
  (`latent_to_patch`).
* The forward: per-image context lengths ~ Geometric(1/E[ctx]) clamped to
  the static `max_context_length`, the tokens [CLS, ctx..., PRD], the base
  trunk under a key mask [B, 1, 1, N] that exposes CLS (if used), the first
  L_i contexts and PRD, and the output standardised as the input.

Layout: pixels and patches NHWC at the functions, as in the JAX package;
the convs run NCHW inside.  The transposed convs reproduce
`lax.conv_transpose` with flax's "SAME" / "VALID" padding and an unflipped
kernel: torch's `conv_transpose2d` with the flipped kernel gives the full
output, which is cropped at lax's offset (`ConvTranspose`).

The attention takes the trunk's plain path: the mask is a key mask (not
the packed path's [B, 1|H, N, N]) and N = max_context_length + 2 is far
below the 512 keys at which "auto" leaves it, as in JAX; the predictive
path launches no hand-written kernel.

Randomness: `forward` takes an `Rng` (utils/rng.py) where JAX takes the
"glimpse" key and splits it in JAX's order (lengths, then positions).
Weights are drawn on the CPU from a `torch.Generator` (seed 0 when None),
then moved to `device`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msvit_tpu_torch.models.base.model import BaseViTEncoder, Linear, trunc_normal
from msvit_tpu_torch.models.multistate.model import as_rng
from msvit_tpu_torch.models.predictive.config import PredictiveViTConfig
from msvit_tpu_torch.ops.grid_sample import grid_sample_separable
from msvit_tpu_torch.utils.math import linspace


def batch_norm(x: torch.Tensor, dims: Tuple[int, ...], eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm without affine: standardise each feature over
    `dims` (biased variance)."""
    mean = x.mean(dims, keepdim=True)
    var = x.var(dims, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def _config_scale(config: PredictiveViTConfig, device=None):
    """`patch_config_scale` as (scale, shift) f32 tensors of shape [dof]."""
    s = config.patch_config_scale
    if isinstance(s, (int, float)):
        return (torch.full((config.dof,), float(s), device=device),
                torch.zeros(config.dof, device=device))
    arr = torch.from_numpy(np.asarray(s, dtype=np.float32)[: config.dof]).to(device)
    return arr[:, 0], arr[:, 1]


def geometric_lengths(rng, shape, expected: float, max_len: int, device=None) -> torch.Tensor:
    """Context lengths ~ Geometric(1/expected) on {1, 2, ...}, clamped to
    `max_len` (int64), drawn as `uniform(shape, 1e-7, 1)` from `rng`."""
    u = rng.uniform(shape, 1e-7, 1.0, device)
    k = torch.floor(torch.log(u) / torch.log1p(torch.tensor(-1.0 / expected, device=device)))
    return (k.long() + 1).clamp(1, max_len)


class Conv(nn.Module):
    """flax `nn.Conv` (NCHW here): a cross-correlation computed in the
    compute dtype, `weight [out, in, k, k]`, zero bias."""

    def __init__(self, cin, cout, k, stride, padding, config, generator):
        super().__init__()
        policy = config.policy
        self.compute_dtype = policy.compute
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(trunc_normal((k, k, cin, cout), config.initializer_range,
                                                generator).permute(3, 2, 0, 1)
                                   .contiguous().to(policy.param))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=policy.param))

    def forward(self, x):
        c = self.compute_dtype
        return F.conv2d(x.to(c), self.weight.to(c), self.bias.to(c), self.stride,
                        self.padding)


def _lax_transpose_padding(k: int, s: int, padding: str) -> Tuple[int, int]:
    """`lax._conv_transpose_padding`: the (before, after) padding of the
    stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(padding)
    return pad_a, pad_len - pad_a


class ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose` (`lax.conv_transpose`, kernel not flipped)
    with "SAME" or "VALID" padding: `conv_transpose2d` with the flipped
    kernel (`weight [in, out, k, k]`, flipped at conversion) gives the full
    output, (n - 1) s + k per axis, and lax's is its slice from
    k - 1 - pad_before, (n - 1) s + 1 + pad_before + pad_after - k + 1
    long."""

    def __init__(self, cin, cout, k, stride, padding, config, generator):
        super().__init__()
        policy = config.policy
        self.compute_dtype = policy.compute
        self.k, self.stride = k, stride
        self.pads = _lax_transpose_padding(k, stride, padding)
        kernel = trunc_normal((k, k, cin, cout), config.initializer_range, generator)
        self.weight = nn.Parameter(kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
                                   .to(policy.param))
        self.bias = nn.Parameter(torch.zeros(cout, dtype=policy.param))

    def forward(self, x):
        c = self.compute_dtype
        y = F.conv_transpose2d(x.to(c), self.weight.to(c), self.bias.to(c), self.stride)
        a, b = self.pads
        off = self.k - 1 - a
        n = [(d - 1) * self.stride + 1 + a + b - self.k + 1 for d in x.shape[-2:]]
        return y[..., off:off + n[0], off:off + n[1]]


class PredictiveViTPatchEmbeddings(nn.Module):
    """The glimpse tokenizer: sampling, the conv encoder and its mirror
    decoder."""

    def __init__(self, config: PredictiveViTConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        p, d, ch = config.patch_size, config.hidden_size, config.num_channels
        g = generator
        self.enc_convs = nn.ModuleList([
            Conv(ch, 64, 5, 1, 2, config, g),
            Conv(64, 128, 4, 2, 1, config, g),
            Conv(128, 256, 4, 2, 1, config, g),
            Conv(256, 512, 4, 2, 1, config, g),
            Conv(512, 1024, p // 8, 1, 0, config, g),
        ])
        self.enc_dense = Linear(1024, d, True, config, g)
        self.dec_dense = Linear(d, 1024, True, config, g)
        self.dec_convs = nn.ModuleList([
            ConvTranspose(1024, 512, p // 8, 1, "VALID", config, g),
            ConvTranspose(512, 256, 4, 2, "SAME", config, g),
            ConvTranspose(256, 128, 4, 2, "SAME", config, g),
            ConvTranspose(128, 64, 4, 2, "SAME", config, g),
            ConvTranspose(64, ch, 5, 1, "SAME", config, g),
        ])

    def _diag(self, patch_config: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.patch_config == "translation":
            return torch.full(patch_config.shape[:-1] + (2,), cfg.default_patch_scale,
                              device=patch_config.device)
        if cfg.patch_config == "scaling":
            return torch.exp(patch_config[..., 2:3]) * torch.ones(
                patch_config.shape[:-1] + (2,), device=patch_config.device)
        if cfg.patch_config == "non-uniform-scaling":
            return torch.exp(patch_config[..., 2:4].clamp_max(0.0))
        raise ValueError(cfg.patch_config)

    def grid_sample_points(self, patch_config: torch.Tensor,
                           bbox_only: bool = False) -> torch.Tensor:
        """The affine sample lattice of each dof vector, [..., P, P, 2] in
        the (y, x)-flipped convention ([..., 2, 2, 2]: its corners, with
        `bbox_only`)."""
        diag = self._diag(patch_config)
        t = (1.0 - diag) * patch_config[..., :2]  # scale-restricted translation
        lin = (torch.tensor([-1.0, 1.0], device=patch_config.device) if bbox_only
               else linspace(-1.0, 1.0, self.config.patch_size, patch_config.device))
        g0, g1 = torch.meshgrid(lin, lin, indexing="ij")
        pts = torch.stack([g0, g1], dim=-1)
        return pts * diag[..., None, None, :] + t[..., None, None, :]

    def _axis_coords(self, patch_config: torch.Tensor):
        """The lattice per axis: (ys, xs) [..., P]."""
        diag = self._diag(patch_config)
        t = (1.0 - diag) * patch_config[..., :2]
        lin = linspace(-1.0, 1.0, self.config.patch_size, patch_config.device)
        return lin * diag[..., 0:1] + t[..., 0:1], lin * diag[..., 1:2] + t[..., 1:2]

    def position_to_patch(self, pixel_values: torch.Tensor,
                          patch_config: torch.Tensor) -> torch.Tensor:
        """Bicubic, border-padded glimpses: pixel_values [B, H, W, C],
        patch_config [B, N..., dof] -> [B, N..., P, P, C]."""
        ys, xs = self._axis_coords(patch_config)
        return grid_sample_separable(pixel_values, ys, xs, "bicubic", "border")

    def patch_to_latent(self, patches: torch.Tensor) -> torch.Tensor:
        """[..., P, P, C] -> [..., D]."""
        lead = patches.shape[:-3]
        x = patches.reshape((-1,) + patches.shape[-3:]).permute(0, 3, 1, 2)
        for conv in self.enc_convs:
            x = F.silu(conv(x))
        x = self.enc_dense(x.reshape(x.shape[0], -1))  # [B*, 1024] -> [B*, D]
        return x.reshape(lead + (self.config.hidden_size,))

    def latent_to_patch(self, latent: torch.Tensor) -> torch.Tensor:
        """[..., D] -> [..., P, P, C]: SiLU before every transposed conv,
        none after the last."""
        lead = latent.shape[:-1]
        x = self.dec_dense(latent.reshape(-1, latent.shape[-1]))[:, :, None, None]
        for conv in self.dec_convs:
            x = conv(F.silu(x))
        x = x.permute(0, 2, 3, 1)
        return x.reshape(lead + x.shape[-3:])

    def forward(self, pixel_values: torch.Tensor, patch_config: torch.Tensor) -> torch.Tensor:
        """Sample, encode, standardise over (batch, tokens)."""
        emb = self.patch_to_latent(self.position_to_patch(pixel_values, patch_config))
        return batch_norm(emb.float(), (0, 1)).to(emb.dtype)


class PredictiveViTModel(nn.Module):
    """Embeddings + trunk + output standardisation.  State-dict keys:
    ``patch_embeddings.*``, ``position_encoder.*``,
    ``position_decoder_kernel [D, dof]`` (and ``position_decoder_bias``
    with `pe_bias`), ``cls_token``, ``prd_token``, ``encoder.layer.i.*``."""

    def __init__(self, config: PredictiveViTConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        config.check_supported()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        g, d, std = generator, config.hidden_size, config.initializer_range
        param = config.policy.param
        self.patch_embeddings = PredictiveViTPatchEmbeddings(config, g)
        self.position_encoder = Linear(config.dof, d, config.pe_bias, config, g)
        self.position_decoder_kernel = nn.Parameter(
            trunc_normal((d, config.dof), std, g).to(param))
        self.position_decoder_bias = (
            nn.Parameter(torch.zeros(config.dof, dtype=param)) if config.pe_bias else None)
        self.cls_token = nn.Parameter(trunc_normal((d,), std, g).to(param))
        self.prd_token = nn.Parameter(trunc_normal((d,), std, g).to(param))
        self.encoder = BaseViTEncoder(config, g)
        if device is not None:
            self.to(device)

    def sample_initial(self, rng, shape: Tuple[int, ...], device=None) -> torch.Tensor:
        """Uniform dof vectors in [-1, 1], config-scaled: [*shape, dof]."""
        u = rng.uniform(tuple(shape) + (self.config.dof,), -1.0, 1.0, device)
        scale, shift = _config_scale(self.config, device)
        return u * scale + shift

    def latent_to_position(self, x: torch.Tensor, return_orthogonal: bool = False):
        """Latent -> sigmoid -> scaled position [..., dof] f32; with
        `return_orthogonal` also the component of x orthogonal to the
        decoder's row space, through pinv(K) = (K^T K)^-1 K^T (normal
        equations; K [D, dof] has full column rank)."""
        kernel = self.position_decoder_kernel.float()
        proj = x.float() @ kernel
        y = proj if self.position_decoder_bias is None else proj + self.position_decoder_bias
        scale, shift = _config_scale(self.config, x.device)
        y = torch.sigmoid(y) * scale + shift
        if not return_orthogonal:
            return y, None
        pinv = torch.linalg.solve(kernel.T @ kernel, kernel.T)  # [dof, D]
        return y, x.float() - proj @ pinv

    def embed(self, pixel_values: torch.Tensor, patch_config: torch.Tensor) -> torch.Tensor:
        """Patch plus position embeddings, [CLS, ctx..., PRD]."""
        cfg = self.config
        emb = (self.patch_embeddings(pixel_values, patch_config)
               + self.position_encoder(patch_config.to(cfg.policy.compute)))
        b = pixel_values.shape[0]
        cls = self.cls_token.expand(b, 1, cfg.hidden_size).to(emb.dtype)
        prd = self.prd_token.expand(b, 1, cfg.hidden_size).to(emb.dtype)
        return torch.cat([cls, emb, prd], dim=1)

    def forward(
        self,
        pixel_values: torch.Tensor,  # [B, H, W, C]
        rng=None,
        context_lengths: Optional[torch.Tensor] = None,
        patch_config: Optional[torch.Tensor] = None,
        output_inputs: bool = False,
    ) -> Dict[str, Any]:
        """`rng`: an `Rng`, an int seed, or None (a seed from the default
        CPU generator); it draws what is not given: the context lengths
        [B], then the positions [B, max_context_length, dof]."""
        cfg = self.config
        b, dev = pixel_values.shape[0], pixel_values.device
        if context_lengths is None or patch_config is None:
            rng = as_rng(rng)
        if context_lengths is None:
            rng, k = rng.split(2)
            context_lengths = geometric_lengths(k, (b,), cfg.expected_context_length,
                                                cfg.max_context_length, dev)
        if patch_config is None:
            rng, k = rng.split(2)
            patch_config = self.sample_initial(k, (b, cfg.max_context_length), dev)

        embeddings = self.embed(pixel_values, patch_config)  # [B, n + 2, D]
        n = cfg.max_context_length
        k_idx = torch.arange(n + 2, device=dev)
        mask = (k_idx[None] <= context_lengths[:, None]) | (k_idx[None] == n + 1)
        if not cfg.use_cls_token:
            mask[:, 0] = False
        out, all_hidden, all_attn = self.encoder(embeddings,
                                                 attention_mask=mask[:, None, None, :])
        out = batch_norm(out.float(), (0, 1)).to(out.dtype)
        return {
            "input_position": patch_config,
            "input_hidden_state": embeddings if output_inputs else None,
            "context_lengths": context_lengths,
            "last_hidden_state": out,
            "hidden_states": all_hidden,
            "attentions": all_attn,
        }
