"""K6's bf16 wgmma kernels against variants of themselves on one CUDA card,
in one process.

    python3 tools/k6_variants_ab.py    # from the repo root, on a machine with a card

Each variant is the kernel library built from a copy of
`msvit_tpu_torch/csrc` with one textual patch of
`attention_bwd_wgmma.cuh` (`VARIANTS`), into a temporary directory; the
wrapper `flash_attention_bwd` is handed each library in turn:
* "per_item": `persistent_grid` returns the item count, so that each block
  takes one item instead of one block an SM walking them;
* "serial": the dK/dV kernel runs a warpgroup's products one group at a
  time (the previous tile's dV and dK, then this tile's S^T and dP^T), as
  K2's pair does, instead of issuing both groups at once and forming p^T
  and ds^T while the second runs.
Times K6 bf16 at [8,12,816,64] with the soft mask of a random 9-cluster
partition and with no mask, at [8,12,1361,64] with a key-only mask and at
[8,12,3168,64] with a soft mask (K5-lse's or K7-lse's residuals, a strided
cotangent): its dQ and dK/dV kernels alone (`chip_smoke.device_ms`, 10
calls a profile) and the wrapper (median of 20, CUDA events), the variants
in turns forward then backward (base first and last); each variant's dq,
dk and dv against the base's bit for bit.  Prints one line, "VARIANTS "
and a JSON object.
"""
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as c  # noqa: E402
from msvit_tpu_torch.models.subsample import build_quadtree  # noqa: E402
from msvit_tpu_torch.ops import _build  # noqa: E402
from msvit_tpu_torch.ops import flash_attention as fl  # noqa: E402
from msvit_tpu_torch.ops import fused_attention as fa  # noqa: E402
from msvit_tpu_torch.ops import packed_attention as pa  # noqa: E402

_SERIAL_OLD = """      fence_acc(dk);
      fence_acc(dv);
      products(s);
      if (t > 0) {
        accumulate((gt - 1) % kBwdStages);
        wgmma_wait<1>();  // S^T and dP^T of tile t
      } else {
        wgmma_wait<0>();
      }
      fence_acc(sc);
      fence_acc(dp);
      if (t == tiles - 1 && lane == 0) mbar_arrive(kvempty);  // K and V are read
      form(t, s);  // while dV and dK of tile t - 1 run
      if (t + 1 < tiles) load_mask(t + 1);  // arrives during the next tile's products
      if (t > 0) release((gt - 1) % kBwdStages);
"""
_SERIAL_NEW = """      if (t > 0) {
        fence_acc(dk);
        fence_acc(dv);
        wgmma_fence();
        accumulate((gt - 1) % kBwdStages);
        release((gt - 1) % kBwdStages);
      }
      products(s);
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      if (t == tiles - 1 && lane == 0) mbar_arrive(kvempty);  // K and V are read
      form(t, s);
      if (t + 1 < tiles) load_mask(t + 1);  // arrives during the next tile's products
"""
VARIANTS = {
    "per_item": ("return static_cast<int>(items < sms ? items : sms);",
                 "return static_cast<int>(items);"),
    "serial": (_SERIAL_OLD, _SERIAL_NEW),
}


def variant_library(tmp: str, name: str):
    """The kernel library built from a copy of the sources with `name`'s
    patch."""
    old, new = VARIANTS[name]
    src = Path(tmp) / name / "csrc"
    shutil.copytree(_build.CSRC, src)
    header = src / "attention_bwd_wgmma.cuh"
    text = header.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"variant {name}: its patch does not apply")
    header.write_text(text.replace(old, new))
    own = _build.CSRC, _build.BUILD_DIR, _build._lib
    _build.CSRC, _build.BUILD_DIR, _build._lib = src, Path(tmp) / name / "build", None
    lib = _build.library()
    _build.CSRC, _build.BUILD_DIR, _build._lib = own
    return lib


def main() -> None:
    smi = c.card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"base": _build.library()}
    with tempfile.TemporaryDirectory(prefix="k6_variants_") as tmp:
        for name in VARIANTS:
            libs[name] = variant_library(tmp, name)
        order = list(libs) + list(libs)[::-1]
        res = {"card": smi, "order": order}
        g = torch.Generator().manual_seed(13)
        b, h, _, dh = c.MS_SHAPE
        depth = torch.from_numpy(
            build_quadtree(c.subsample_config(image_size=448, max_depth=3)).depth).float()
        nk = c.SS_SHAPE[2]
        valid = torch.rand(b, nk - 1, generator=g) < 0.6
        key = torch.cat([torch.zeros(b, 1),
                         torch.where(valid, 0.0, -1e30) - math.log(4) * depth],
                        dim=-1)[:, None, None, :].to(dev)
        cases = (("816", c.MS_SHAPE[2], "soft"), ("816_nomask", c.MS_SHAPE[2], None),
                 ("key_1361", nk, key), ("3168", c.MS448_SHAPE[2], "soft"))
        for label, n, mask in cases:
            if mask == "soft":
                ids = torch.randint(0, 9, (b, n - 2 * c.MS_CLUSTERS), generator=g)
                mask = c._soft(ids.to(dev), 9)
            q, k, v = pa.unpack_qkv(torch.randn(b, n, 3 * h * dh, generator=g).to(dev)
                                    .to(torch.bfloat16), h)
            gr = torch.randn(b, n, h, dh, generator=g).to(dev).to(torch.bfloat16).transpose(1, 2)
            with torch.no_grad():
                fwd = fa.fused_attention_lse if n < 3000 else fl.flash_attention_lse
                o, lse = fwd(q, k, v, mask=mask)

                def bwd():
                    return fl.flash_attention_bwd(q, k, v, o, gr, lse, mask)

                times, outs = {}, {}
                for name in order:
                    _build._lib = libs[name]
                    t = times.setdefault(name, {"dq_alone_ms": [], "dkv_alone_ms": [],
                                                "ms": []})
                    for which in ("dq", "dkv"):
                        t[f"{which}_alone_ms"].append(
                            c.device_ms(bwd, rf"flash_bwd_{which}_wgmma_kernel"))
                    t["ms"].extend(c.time_ms(bwd, runs=20))
                    outs[name] = bwd()
                torch.cuda.synchronize()
            _build._lib = libs["base"]
            for t in times.values():
                t["ms"] = statistics.median(t["ms"])
            res[label] = {name: {**t, "same_bits_as_base": all(
                torch.equal(x, y) for x, y in zip(outs[name], outs["base"]))}
                for name, t in times.items()}
            del q, k, v, gr, o, lse, mask, outs
            torch.cuda.empty_cache()
    print("VARIANTS " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
