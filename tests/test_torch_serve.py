"""PyTorch port, `msvit_tpu_torch/serve.py`: the cases of
tests/test_serve.py (results match a direct forward, static buckets,
concurrent submitters, errors propagate, small-bucket routing), plus the
int8/bf16 ViT apply functions of the serving path behind the server."""

import threading

import numpy as np
import pytest
import torch

from msvit_tpu_torch.serve import BatchingServer

W = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32))


def _model():
    seen_shapes = []

    def apply_fn(x):
        seen_shapes.append(x.shape)
        with torch.inference_mode():
            return torch.from_numpy(x) @ W

    return apply_fn, seen_shapes


def test_results_match_direct_forward():
    apply_fn, seen = _model()
    xs = np.random.default_rng(1).standard_normal((23, 8)).astype(np.float32)
    with BatchingServer(apply_fn, xs[0], max_batch=8, max_wait_ms=5.0) as srv:
        srv.warmup()
        futs = [srv.submit(x) for x in xs]
        got = np.stack([f.result(timeout=30).numpy() for f in futs])
    np.testing.assert_allclose(got, xs @ W.numpy(), rtol=1e-5)
    assert all(s[0] in (1, 2, 4, 8) for s in seen)


def test_concurrent_submitters():
    apply_fn, _ = _model()
    xs = np.random.default_rng(2).standard_normal((40, 8)).astype(np.float32)
    results = {}
    with BatchingServer(apply_fn, xs[0], max_batch=16, max_wait_ms=2.0) as srv:
        srv.warmup()

        def client(lo, hi):
            for i in range(lo, hi):
                results[i] = srv.submit(xs[i]).result(timeout=30)

        threads = [threading.Thread(target=client, args=(i * 10, (i + 1) * 10))
                   for i in range(4)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        stats = srv.stats()
    want = xs @ W.numpy()
    for i in range(40):
        np.testing.assert_allclose(results[i].numpy(), want[i], rtol=1e-4, atol=1e-5)
    assert stats["requests"] == 40
    assert stats["p50_ms"] > 0 and stats["batches"] >= 3


def test_stress_many_submitters_no_lost_request():
    """More client threads than cores, a short switch interval: every
    request gets its own row back and the stats count each exactly once."""
    import os
    import sys

    apply_fn, _ = _model()
    n_threads = 2 * (os.cpu_count() or 4)
    xs = np.random.default_rng(5).standard_normal((n_threads * 8, 8)).astype(np.float32)
    results = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with BatchingServer(apply_fn, xs[0], max_batch=16, max_wait_ms=1.0) as srv:
            def client(lo):
                for i in range(lo, lo + 8):
                    results[i] = srv.submit(xs[i]).result(timeout=60)

            threads = [threading.Thread(target=client, args=(8 * t,))
                       for t in range(n_threads)]
            [t.start() for t in threads]
            [t.join(timeout=120) for t in threads]
            assert not any(t.is_alive() for t in threads)
            stats = srv.stats()
    finally:
        sys.setswitchinterval(old)
    want = xs @ W.numpy()
    assert sorted(results) == list(range(len(xs)))
    for i, got in results.items():
        np.testing.assert_allclose(got.numpy(), want[i], rtol=1e-4, atol=1e-5)
    assert stats["requests"] == len(xs)


def test_shape_mismatch_rejected_and_errors_propagate():
    def bad_apply(x):
        raise RuntimeError("boom")

    srv = BatchingServer(bad_apply, np.zeros(8, np.float32), max_batch=4)
    try:
        with pytest.raises(ValueError, match="request shape"):
            srv.submit(np.zeros(7, np.float32))
        fut = srv.submit(np.zeros(8, np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    finally:
        srv.close()


def test_small_bucket_dtype_routing():
    small_shapes, big_shapes = [], []

    def big(x):
        big_shapes.append(x.shape)
        return torch.from_numpy(x) @ W

    def small(x):
        small_shapes.append(x.shape)
        return torch.from_numpy(x) @ W

    xs = np.random.default_rng(3).standard_normal((9, 8)).astype(np.float32)
    with BatchingServer(big, xs[0], max_batch=8, max_wait_ms=5.0,
                        small_apply_fn=small, small_bucket_max=2) as srv:
        srv.warmup()
        assert {s[0] for s in small_shapes} == {1, 2}
        assert {s[0] for s in big_shapes} == {4, 8}
        small_shapes.clear(), big_shapes.clear()
        got = srv.submit(xs[0]).result(timeout=30)
        np.testing.assert_allclose(got.numpy(), (xs[:1] @ W.numpy())[0], rtol=1e-5)
        assert small_shapes and all(s[0] <= 2 for s in small_shapes)
        futs = [srv.submit(x) for x in xs[1:]]
        res = np.stack([f.result(timeout=30).numpy() for f in futs])
    np.testing.assert_allclose(res, xs[1:] @ W.numpy(), rtol=1e-5)
    assert any(s[0] >= 4 for s in big_shapes)


def test_tuple_outputs_split_per_request():
    def apply_fn(x):
        t = torch.from_numpy(x)
        return {"sum": t.sum(-1)}, t * 2

    xs = np.arange(12, dtype=np.float32).reshape(3, 4)
    with BatchingServer(apply_fn, xs[0], max_batch=4, max_wait_ms=5.0) as srv:
        outs = [f.result(timeout=30) for f in [srv.submit(x) for x in xs]]
    for x, (d, y) in zip(xs, outs):
        assert float(d["sum"]) == x.sum()
        np.testing.assert_array_equal(y.numpy(), x * 2)


def test_vit_int8_and_bf16_serving_path():
    """The serving wiring of the port at a tiny size: uint8 HWC requests,
    normalised on the device, int8 buckets (K3 path, calibrated) and bf16
    small buckets (K1 path); each response equals a direct call of the
    apply function that served it (CPU, the same arithmetic: 1e-5)."""
    from msvit_tpu_torch.models.base import BaseViTConfig, ViTModel
    from msvit_tpu_torch.models.base.quantized import (
        calibrate_act_scales, quantize_vit_params, quantized_vit_apply)

    cfg = BaseViTConfig(hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, image_size=32, patch_size=16)
    model = ViTModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    qparams = quantize_vit_params(model)
    calib = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    scales = calibrate_act_scales(qparams, cfg, calib, use_kernels=True)

    def normalize(u8):
        return torch.from_numpy(u8).float() / 127.5 - 1.0

    def int8_fn(u8):
        with torch.inference_mode():
            f = quantized_vit_apply(qparams, cfg, normalize(u8),
                                    act_scales=scales, use_kernels=True)
            return f[:, 0].float(), torch.ones(len(u8))

    def bf16_fn(u8):
        with torch.inference_mode():
            f = model(normalize(u8))["last_hidden_state"]
            return f[:, 0].float(), torch.zeros(len(u8))

    imgs = np.random.default_rng(4).integers(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    with BatchingServer(int8_fn, imgs[0], max_batch=8, max_wait_ms=20.0,
                        small_apply_fn=bf16_fn, small_bucket_max=2) as srv:
        srv.warmup()
        single = srv.submit(imgs[0]).result(timeout=60)
        burst = [f.result(timeout=60) for f in [srv.submit(x) for x in imgs]]
    direct = {1.0: int8_fn(imgs)[0], 0.0: bf16_fn(imgs)[0]}
    assert float(single[1]) == 0.0  # bucket 1 -> bf16
    assert any(float(r[1]) == 1.0 for r in burst)  # a burst -> int8
    np.testing.assert_allclose(single[0].numpy(), direct[0.0][0].numpy(), atol=1e-5)
    for i, (feat, route) in enumerate(burst):
        assert torch.isfinite(feat).all()
        np.testing.assert_allclose(feat.numpy(), direct[float(route)][i].numpy(),
                                   atol=1e-5)
