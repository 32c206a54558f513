"""Figures for qualitative inspection (counterpart of `msvit_tpu/viz.py`);
host matplotlib, off every compute path.  Each function takes tensors (on
any device) or numpy arrays; matplotlib is imported inside them only, so
the port never needs it to run (the card's machine may lack it).  The
t-SNE embeddings are computed by `ops/tsne.py` on the features' device.

* ``visualize_subsample_output``: the nested quadtree, sampled patches in
  their boxes and the sigmoid subdivision decisions per depth;
* ``visualize_predictive_sample``: glimpse boxes and predicted positions;
* ``color`` / ``confidence_ellipse``: plotting helpers;
* ``visualize_tsne_clusters``: the spectral-debug t-SNE scatter;
* ``visualize_spectral_debug``: the spectral clustering's debug figure
  set (label-grid rows and per-image t-SNE panels).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _np(x, dtype=None) -> np.ndarray:
    """A tensor (any device, any dtype) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy() if x.is_floating_point() else x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def color(z: float, scale: float = 120.0) -> np.ndarray:
    """Cyclic RGB cluster-id palette: three phase-shifted sinusoids mapped
    to [0, 1]."""
    k = 2.0 * np.pi * z / scale
    phases = k + (2.0 * np.pi / 3.0) * np.arange(3)
    return 0.5 * (1.0 + np.sin(phases))


def confidence_ellipse(x, y, ax, n_std: float = 1.0, facecolor="none", **kwargs):
    """Confidence ellipse (matplotlib's gallery recipe) of the uncentered
    second-moment matrix E[x y^T], as the JAX package draws it."""
    from matplotlib import transforms
    from matplotlib.patches import Ellipse

    x, y = _np(x), _np(y)
    if x.size != y.size:
        raise ValueError("x and y must be the same size")
    m = np.stack([x, y], axis=0)
    cov = (m @ m.T) / len(x)
    pearson = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    ellipse = Ellipse(
        (0, 0),
        width=np.sqrt(1 + pearson) * 2,
        height=np.sqrt(1 - pearson) * 2,
        facecolor=facecolor,
        **kwargs,
    )
    transf = (
        transforms.Affine2D()
        .rotate_deg(45)
        .scale(np.sqrt(cov[0, 0]) * n_std, np.sqrt(cov[1, 1]) * n_std)
    )
    ellipse.set_transform(transf + ax.transData)
    return ax.add_patch(ellipse)


def _denormalize(im: np.ndarray, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
    return np.clip(im * np.asarray(std) + np.asarray(mean), 0.0, 1.0)


def visualize_subsample_output(
    outputs: Dict[str, Any],
    tree,
    num_ims: int = 3,
    mean=(0.5, 0.5, 0.5),
    std=(0.5, 0.5, 0.5),
    show: bool = True,
    save_path: Optional[str] = None,
):
    """Render the nested quadtree (patches in boxes; decision heat map).

    `outputs` is a `SubsampleViTForImageClassification` result with
    ``output_logs=True`` and ``return_pixel_values=True``; `tree` the
    model's `QuadTree`.  Corners are (y, x), normalised."""
    from matplotlib import pyplot as plt

    logs = outputs["logs"]
    pixels = _np(outputs["pixel_values"], np.float32)  # [B,cap,P,P,C]
    depths = len(logs["valid_masks"])
    num_ims = min(num_ims, len(pixels))
    corners_all = np.asarray(tree.corners)

    nrows, ncols = 2, depths * num_ims
    fig, axs = plt.subplots(
        nrows=nrows, ncols=ncols, figsize=(2.0 * ncols, 2.0 * nrows),
        squeeze=False,
    )
    for im_idx in range(num_ims):
        for depth in range(depths):
            valid = _np(logs["valid_masks"][depth][im_idx]).astype(bool)
            corners = corners_all[valid]
            patches = _denormalize(pixels[im_idx][valid], mean, std)
            logits = _np(logs["subsample_logits"][depth][im_idx])[valid]
            sig = 1.0 / (1.0 + np.exp(-logits))

            ax_im = axs[0, im_idx * depths + depth]
            ax_im.axis("off")
            ax_im.set_aspect("equal")
            for pv, c in zip(patches, corners):
                ax_im.imshow(
                    pv,
                    extent=(c[0, 1], c[1, 1], c[1, 0], c[0, 0]),
                    interpolation="none",
                )
            for c in corners:
                ax_im.plot(
                    [c[0, 1], c[0, 1], c[1, 1], c[1, 1], c[0, 1]],
                    [c[0, 0], c[1, 0], c[1, 0], c[0, 0], c[0, 0]],
                    color="gold",
                    linewidth=2.0 * abs(c[1, 0] - c[0, 0]),
                    linestyle="--",
                )
            ax_im.set_title(f"Image {im_idx}: depth {depth}")

            ax_dt = axs[1, im_idx * depths + depth]
            ax_dt.axis("off")
            ax_dt.set_aspect("equal")
            for s, c in zip(sig, corners):
                ax_dt.imshow(
                    np.asarray(s)[None, None],
                    cmap="seismic",
                    vmin=0.4,
                    vmax=0.6,
                    extent=(c[0, 1], c[1, 1], c[1, 0], c[0, 0]),
                    interpolation="none",
                )
                center = (c[0] + c[1]) / 2
                ax_dt.text(
                    center[1],
                    center[0],
                    f"{float(s):.2f}",
                    fontsize=12.0 * abs(c[1, 0] - c[0, 0]) ** 0.5,
                    ha="center",
                    va="center",
                )
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return fig


def visualize_predictive_sample(
    pixel_values,  # [B, H, W, C], normalized
    output: Dict[str, Any],
    meta: Dict[str, Any],
    model,
    num_ims: int = 3,
    show: bool = True,
    save_path: Optional[str] = None,
):
    """Glimpse boxes (black) and predicted positions (purple) over the
    images.  `model` is the `PredictiveViTModel` whose forward gave
    `output`; its patch embeddings give each glimpse's corner grid.  At
    most `num_ims` images (fewer when the batch is smaller)."""
    from matplotlib import pyplot as plt

    def bbox_of(positions):
        positions = torch.as_tensor(positions)
        with torch.no_grad():
            return _np(model.patch_embeddings.grid_sample_points(positions, True))

    sample_grid = bbox_of(output["input_position"])  # [..., 2, 2, 2] (y, x)
    have_pred = "predicted_context_position" in meta
    if have_pred:
        pred_grid = bbox_of(meta["predicted_context_position"])

    num_ims = min(num_ims, len(pixel_values))
    fig, axs = plt.subplots(1, num_ims, figsize=(4.0 * num_ims, 4.0), squeeze=False)
    for i in range(num_ims):
        ax = axs[0, i]
        ax.set_aspect("equal")
        im = _np(pixel_values[i])
        im = (im - im.min()) / max(im.max() - im.min(), 1e-6)
        ax.imshow(im, extent=(-1.0, 1.0, 1.0, -1.0))
        n_ctx = int(output["context_lengths"][i])
        for j in range(n_ctx):
            g = sample_grid[i, j]  # [2, 2, 2] corners (y, x)
            ys = [g[0, 0, 0], g[0, 1, 0], g[1, 1, 0], g[1, 0, 0], g[0, 0, 0]]
            xs = [g[0, 0, 1], g[0, 1, 1], g[1, 1, 1], g[1, 0, 1], g[0, 0, 1]]
            ax.plot(xs, ys, color="black", linestyle="--", linewidth=1.5)
            if have_pred:
                pg = pred_grid[i, j]
                pys = [pg[0, 0, 0], pg[0, 1, 0], pg[1, 1, 0], pg[1, 0, 0], pg[0, 0, 0]]
                pxs = [pg[0, 0, 1], pg[0, 1, 1], pg[1, 1, 1], pg[1, 0, 1], pg[0, 0, 1]]
                ax.plot(pxs, pys, color="purple", linestyle="--", linewidth=1.5)
        ax.set_title(f"Image {i}")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return fig


def visualize_tsne_clusters(
    features,  # [n, d], e.g. NCut eigenvectors
    labels=None,  # [n] cluster ids for the colours
    dim: int = 2,
    perplexity: float = 30.0,
    show: bool = True,
    save_path: Optional[str] = None,
):
    """t-SNE scatter of clustering features, coloured by cluster id; the
    embedding by `ops/tsne.py` on the features' device."""
    from matplotlib import pyplot as plt

    from msvit_tpu_torch.ops.tsne import tsne

    y, _ = tsne(torch.as_tensor(features).float(), dim=dim, perplexity=perplexity)
    y = _np(y)
    if labels is None:
        cs = None
    else:
        cs = np.stack([color(float(lab)) for lab in _np(labels)])
    fig = plt.figure(figsize=(5.0, 5.0))
    if dim == 3:
        ax = fig.add_subplot(projection="3d")
        ax.scatter(y[:, 0], y[:, 1], y[:, 2], c=cs, s=8)
    else:
        ax = fig.add_subplot()
        ax.set_aspect("equal")
        ax.scatter(y[:, 0], y[:, 1], c=cs, s=8)
    ax.set_title("t-SNE of clustering features")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return fig


def visualize_spectral_debug(
    ncut_x,  # [bsz, N, ncut_dim] NCut eigenvectors
    grid,  # (h, w) patch grid, h * w == N
    key=None,  # an Rng (seed 0 when None)
    images: int = 3,
    cluster_size_threshold: float = 0.02,
    min_samples: int = 512,
    tsne_iters: int = 500,
    show: bool = True,
    save_prefix: Optional[str] = None,
):
    """The spectral clustering's debug figures, from the port's ops:

    * per image (the first ``images``), each NCut dimension painted on the
      patch grid ("bwr");
    * one row per labelling of `spectral_debug_labels` (HDBSCAN, centroid,
      seeded KMeans, axis-aligned), the first ``images`` images side by
      side in the cluster palette (noise grey);
    * per image, the 2-D t-SNE scattered with the min-max-normalised 3-D
      t-SNE as RGB, and that RGB painted on the patch grid.

    Returns ``(figs, labels)``: the figures and the label OrderedDict."""
    from matplotlib import pyplot as plt

    from msvit_tpu_torch.models.clustering import spectral_debug_labels
    from msvit_tpu_torch.ops.tsne import tsne
    from msvit_tpu_torch.utils.rng import Rng

    device = ncut_x.device if isinstance(ncut_x, torch.Tensor) else "cpu"
    ncut_x = _np(ncut_x, np.float32)
    bsz, n_tok, ncut_dim = ncut_x.shape
    h, w = grid
    if h * w != n_tok:
        raise ValueError(f"grid {grid} does not tile N={n_tok}")
    if key is None:
        key = Rng(0)
    images = min(images, bsz)
    figs = []

    # eigenvector heat-maps: one row per image, columns = NCut dims
    fig, axs = plt.subplots(
        nrows=images,
        ncols=ncut_dim,
        figsize=(1.6 * ncut_dim, 1.6 * images),
        squeeze=False,
    )
    vmax = np.abs(ncut_x[:images]).max() + 1e-8
    for i in range(images):
        for j in range(ncut_dim):
            axs[i, j].imshow(
                ncut_x[i, :, j].reshape(h, w), cmap="bwr", vmin=-vmax, vmax=vmax
            )
            axs[i, j].axis("off")
            if i == 0:
                axs[i, j].set_title(f"eig {j}", fontsize=8)
    fig.tight_layout()
    if save_prefix:
        fig.savefig(f"{save_prefix}_eigs.png", bbox_inches="tight")
    figs.append(fig)

    labels = spectral_debug_labels(
        torch.from_numpy(ncut_x.reshape(bsz * n_tok, -1)).to(device),
        key,
        cluster_size_threshold=cluster_size_threshold,
        min_samples=min_samples,
    )
    fig, axs = plt.subplots(
        nrows=len(labels), ncols=1, figsize=(2.5 * images, 2.5 * len(labels))
    )
    axs = np.atleast_1d(axs)
    for ax, (name, lab) in zip(axs, labels.items()):
        cluster_im = np.full((bsz * n_tok, 3), 0.5, np.float32)  # noise gray
        for cid in range(int(lab.max()) + 1):
            cluster_im[lab == cid] = color(float(cid))
        tiles = cluster_im.reshape(bsz, h, w, 3)[:images]
        ax.imshow(np.concatenate(list(tiles), axis=1))
        ax.set_title(name)
        ax.axis("off")
    fig.tight_layout()
    if save_prefix:
        fig.savefig(f"{save_prefix}_labels.png", bbox_inches="tight")
    figs.append(fig)

    for i in range(images):
        xi = torch.from_numpy(ncut_x[i]).to(device)
        y2, _ = tsne(xi, dim=2, n_iter=tsne_iters)
        y3, _ = tsne(xi, dim=3, n_iter=tsne_iters)
        y2, y3 = _np(y2), _np(y3)
        c = (y3 - y3.min(axis=0)) / (np.ptp(y3, axis=0) + 1e-8)
        fig, (ax_s, ax_im) = plt.subplots(ncols=2, figsize=(8.0, 4.0))
        ax_s.scatter(y2[:, 0], y2[:, 1], c=c, s=16)
        ax_s.set_title(f"Image {i}")
        ax_s.set_aspect("equal")
        ax_im.imshow(c.reshape(h, w, 3))
        ax_im.axis("off")
        if save_prefix:
            fig.savefig(f"{save_prefix}_tsne{i}.png", bbox_inches="tight")
        figs.append(fig)

    if show:
        plt.show()
    for f in figs:
        plt.close(f)
    return figs, labels
