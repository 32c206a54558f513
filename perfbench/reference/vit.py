"""Plain ViT and multistate encoder forwards, the reference of the cells.

Written from the published descriptions in plain torch: pre-LN blocks with
LayerScale, fused QKV with 1/sqrt(dh) on the scores, exact softmax, exact
(erf) GELU, LayerNorm over the last axis.  The multistate encoder adds 2C
transmitter / receiver tokens ahead of the patches, a soft additive mask
between them and a spectral re-clustering at its event layers
(`clustering.py`).  Weights come as a dict under the program's state-dict
names, which the benchmark makes from the seed and hands to both sides.

Everything runs in float32 with TF32 off.  `quant` ("int8", "int4" or
"fp8") rounds the operands of every matrix product through that type,
weights per output channel and activations per tensor: the lower-precision
control that the comparison has to reject.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.clustering import spectral_cluster
from perfbench.reference.rng import Stream


def exact_f32() -> None:
    """Matrix products in true float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fake_quant(x: torch.Tensor, kind: str, dim: Optional[int] = None) -> torch.Tensor:
    """x rounded through a symmetric per-tensor (dim None) or per-slice
    (along `dim`) scaling: "int8" and "int4" round to the nearest of
    2^(bits-1) - 1 levels a side, "fp8" to float8 e4m3 with the absmax at
    448."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    amax = amax.clamp_min(1e-8)
    if kind == "fp8":
        scale = amax / 448.0
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    else:
        qmax = {"int8": 127, "int4": 7}[kind]
        scale = amax / qmax
        q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return x + (q - x).detach()  # the gradient passes straight through


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           quant: Optional[str] = None) -> torch.Tensor:
    w = w.float()
    if quant:
        x, w = fake_quant(x, quant), fake_quant(w, quant, dim=1)
    return F.linear(x, w, None if b is None else b.float())


def layer_norm(x: torch.Tensor, sd: Dict, prefix: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[prefix + "weight"].float(),
                        sd[prefix + "bias"].float(), eps)


def patchify(pixels: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, gh*gw, p*p*C], features in (row, column, channel) order."""
    b, h, w, c = pixels.shape
    x = pixels.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def block(x: torch.Tensor, sd: Dict, pre: str, cfg: Dict,
          mask: Optional[torch.Tensor] = None, quant: Optional[str] = None) -> torch.Tensor:
    """One pre-LN block: x + ls1 * attn(LN1 x), then x + ls2 * mlp(LN2 x)."""
    b, n, d = x.shape
    h = cfg["num_attention_heads"]
    dh = d // h
    eps = cfg["layer_norm_eps"]
    y = layer_norm(x, sd, pre + "norm1.", eps)
    qkv = linear(y, sd[pre + "attention.qkv.weight"], sd[pre + "attention.qkv.bias"], quant)
    q, k, v = qkv.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    s = (q @ k.mT) * dh**-0.5
    if mask is not None:
        s = s + mask
    o = (s.softmax(-1) @ v).transpose(1, 2).reshape(b, n, d)
    o = linear(o, sd[pre + "attention.output_dense.weight"],
               sd[pre + "attention.output_dense.bias"], quant)
    x = x + sd[pre + "layer_scale1"].float() * o
    y = layer_norm(x, sd, pre + "norm2.", eps)
    y = F.gelu(linear(y, sd[pre + "mlp.fc1.weight"], sd[pre + "mlp.fc1.bias"], quant))
    y = linear(y, sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"], quant)
    return x + sd[pre + "layer_scale2"].float() * y


def vit_forward(sd: Dict, cfg: Dict, pixels: torch.Tensor,
                quant: Optional[str] = None) -> torch.Tensor:
    """ViT with a CLS token: pixels [B, H, W, C] -> final LayerNorm output
    [B, 1 + N, D] f32."""
    x = linear(patchify(pixels.float(), cfg["patch_size"]),
               sd["embeddings.patch_projection.weight"],
               sd["embeddings.patch_projection.bias"], quant)
    cls = sd["embeddings.cls_token"].float().expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], 1) + sd["embeddings.position_embeddings"].float()
    for i in range(cfg["num_hidden_layers"]):
        x = block(x, sd, f"encoder.layer.{i}.", cfg, quant=quant)
    return layer_norm(x, sd, "layernorm.", cfg["layer_norm_eps"])


def multistate_mask(ids: torch.Tensor, n_clusters: torch.Tensor, c: int,
                    penalty: float) -> torch.Tensor:
    """The additive mask [B, 1, 2C+N, 2C+N]: tokens see their cluster, TX_c
    (position 2c) sees the tokens of c, tokens see their RX_c (2c + 1),
    every valid RX sees every valid TX; 0 where allowed, -penalty elsewhere."""
    b, n = ids.shape
    cid = torch.arange(c, device=ids.device)
    valid = cid[None] < n_clusters.reshape(-1, 1).expand(b, 1)
    in_c = ids[:, None, :] == cid[None, :, None]  # [B, C, N]
    m = torch.zeros((b, 2 * c + n, 2 * c + n), dtype=torch.bool, device=ids.device)
    m[:, 2 * c:, 2 * c:] = ids[:, :, None] == ids[:, None, :]
    m[:, 0:2 * c:2, 2 * c:] = in_c
    m[:, 2 * c:, 1:2 * c:2] = in_c.transpose(1, 2)
    m[:, 1:2 * c:2, 0:2 * c:2] = valid[:, :, None] & valid[:, None, :]
    return torch.where(m, 0.0, -penalty)[:, None]


def multistate_forward(sd: Dict, cfg: Dict, pixels: torch.Tensor, seed: int,
                       quant: Optional[str] = None,
                       forced: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
                       ) -> Dict:
    """The multistate encoder over one batch (clustering pools the whole
    batch): last hidden state [B, N, D] f32, the last partition [B, N], the
    number of clusters, and each clustering event's inputs and outputs
    (`events`).  With `forced`, event e takes the given (child ids,
    children per parent) in place of its own clustering: the trunk follows
    another forward's partitions."""
    cl = cfg["clustering"]
    c = cl["max_clusters"]
    b = pixels.shape[0]
    h = linear(patchify(pixels.float(), cfg["patch_size"]),
               sd["embeddings.patch_projection.weight"],
               sd["embeddings.patch_projection.bias"], quant)
    h = h + sd["embeddings.position_embeddings"].float()
    n, d = h.shape[1:]
    pair = torch.stack([sd["backbone.transmitter_token"], sd["backbone.receiver_token"]])
    tokens = pair.float()[None, None].expand(b, c, 2, d)
    ids = torch.zeros((b, n), dtype=torch.long, device=h.device)
    n_clusters = torch.ones((), dtype=torch.long, device=h.device)
    stream, bound, events = Stream(seed), 1, []
    for i in range(cfg["num_hidden_layers"]):
        if i >= cfg["pregeneration_period"] and i % cfg["generation_period"] == 0:
            stream, key = stream.split(2)
            if forced is None:
                child, per_parent = spectral_cluster(cl, ids, h, key, bound)
            else:
                child, per_parent = forced[len(events)]
            events.append({"parents": ids, "x": h, "key": key.seed, "max_parents": bound,
                           "child": child, "n_children": per_parent})
            ids = child
            cum = per_parent.cumsum(-1)
            parent_of = torch.searchsorted(cum, torch.arange(c, device=h.device),
                                           right=True).clamp(0, c - 1)
            tokens = tokens[:, parent_of]
            n_clusters = cum[-1].clamp_min(1)
            bound = min(bound * cl["ncut_dim"], c)
        mask = multistate_mask(ids, n_clusters, c, cfg["attention_mask_inf"])
        x = block(torch.cat([tokens.reshape(b, 2 * c, d), h], 1), sd,
                  f"backbone.layer.{i}.", cfg, mask, quant)
        tokens, h = x[:, :2 * c].reshape(b, c, 2, d), x[:, 2 * c:]
    return {"last_hidden_state": h, "last_cluster_indices": ids, "num_clusters": n_clusters,
            "events": events}
