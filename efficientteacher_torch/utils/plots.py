"""Plotting utilities (a copy of `efficientteacher_tpu/utils/plots.py`;
parity: reference utils/plots.py:476-1066 subset).

Covers the artifacts the trainers and the validator write: label
statistics, train batch mosaics (with the SSOD variant with pseudo-label
scores), PR / F1 curves, the confusion matrix, results.csv curves and the
pyramid feature maps of `cli.detect --visualize`. matplotlib (Agg) is
imported when a plot is drawn, not with the module: without it each
function raises ImportError naming matplotlib. The trainers skip their
plots then, with a debug log, as JAX's do; an explicit `plots_dir` (the
validator, `cli.val --plots`) raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend; ImportError without
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plots need matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _color(i: int):
    plt = pyplot()
    palette = plt.cm.tab20(np.linspace(0, 1, 20))
    return palette[i % 20]


def plot_labels(labels: Sequence[np.ndarray], nc: int, save_dir: Path,
                names: Optional[Sequence[str]] = None):
    """Class histogram + box geometry scatter (reference plots.py labels)."""
    plt = pyplot()
    all_rows = np.concatenate([lb for lb in labels if len(lb)] or
                              [np.zeros((0, 5))])
    fig, axes = plt.subplots(1, 3, figsize=(14, 4), tight_layout=True)
    axes[0].hist(all_rows[:, 0], bins=max(nc, 1), color="#36a2eb")
    axes[0].set_title("classes")
    if len(all_rows):
        axes[1].scatter(all_rows[:, 1], all_rows[:, 2], s=2, alpha=0.3)
        axes[1].set_title("xy centers")
        axes[2].scatter(all_rows[:, 3], all_rows[:, 4], s=2, alpha=0.3)
        axes[2].set_title("wh")
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    fig.savefig(Path(save_dir) / "labels.png", dpi=150)
    plt.close(fig)


def plot_images(
    images: np.ndarray,        # (B, H, W, 3) uint8 RGB
    labels: np.ndarray,        # (B, M, 5+) [cls, xywhn, (score...)]
    mask: np.ndarray,
    path: Path,
    max_images: int = 16,
    with_scores: bool = False,
):
    """Annotated batch mosaic (reference plot_images / plot_images_ssod)."""
    plt = pyplot()
    b = min(len(images), max_images)
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False, tight_layout=True)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= b:
            continue
        img = images[i]
        h, w = img.shape[:2]
        ax.imshow(img)
        for row, ok in zip(labels[i], mask[i]):
            if not ok:
                continue
            cls = int(row[0])
            cx, cy, bw, bh = row[1] * w, row[2] * h, row[3] * w, row[4] * h
            rect = plt.Rectangle(
                (cx - bw / 2, cy - bh / 2), bw, bh, fill=False,
                edgecolor=_color(cls), linewidth=1,
            )
            ax.add_patch(rect)
            label = str(cls)
            if with_scores and len(row) > 5:
                label += f" {row[5]:.2f}"
            ax.text(cx - bw / 2, cy - bh / 2 - 2, label, fontsize=6,
                    color=_color(cls))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_pr_curve(px, py, ap, save_path: Path, names=()):
    """PR curve at mAP@0.5 (reference plot_pr_curve, metrics.py:312-334):
    per-class lines when < 21 classes, else grey spaghetti + blue mean."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if isinstance(py, list) else py
    if py.ndim == 1:
        py = py[:, None]
    if 0 < py.shape[1] < 21:
        for i in range(py.shape[1]):
            name = names[i] if i < len(names) else str(i)
            ax.plot(px, py[:, i], linewidth=1,
                    label=f"{name} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="#36a2eb",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=7)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)


def plot_mc_curve(px, py, save_path: Path, names=(), xlabel="Confidence",
                  ylabel="Metric"):
    """Metric-vs-confidence curve family: F1/P/R (reference plot_mc_curve,
    metrics.py:337-360)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(9, 6), tight_layout=True)
    py = np.asarray(py)
    if py.ndim == 1:
        py = py[None]
    if 0 < len(py) < 21:
        for i, y in enumerate(py):
            name = names[i] if i < len(names) else str(i)
            ax.plot(px, y, linewidth=1, label=name)
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    mean = py.mean(0)
    ax.plot(px, mean, linewidth=3, color="#36a2eb",
            label=f"all classes {mean.max():.2f} at {px[mean.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=7)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)


def plot_confusion_matrix(matrix: np.ndarray, save_path: Path, names=(),
                          normalize: bool = True):
    """Confusion-matrix heatmap (reference ConfusionMatrix.plot,
    utils/metrics.py:176-199; matplotlib instead of seaborn)."""
    plt = pyplot()
    m = np.asarray(matrix, np.float64)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-6)
    nc = m.shape[0] - 1
    labels = ([names[i] if i < len(names) else str(i) for i in range(nc)]
              + ["background"])
    fig, ax = plt.subplots(figsize=(10, 8), tight_layout=True)
    im = ax.imshow(m, cmap="Blues", vmin=0.0)
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    if len(labels) <= 30:  # annotate cells when readable
        for i in range(m.shape[0]):
            for j in range(m.shape[1]):
                if m[i, j] > 0.005:
                    ax.text(j, i, f"{m[i, j]:.2f}", ha="center",
                            va="center", fontsize=6,
                            color="white" if m[i, j] > 0.5 else "black")
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)


def plot_pseudo_vs_gt(
    images: np.ndarray,         # (B, H, W, 3) uint8 RGB (weak view)
    pseudo_labels: np.ndarray,  # (B, Mp, >=6) [cls, xywhn, conf, ...]
    pseudo_mask: np.ndarray,
    gt_labels: np.ndarray,      # (B, M, 5)
    gt_mask: np.ndarray,
    path: Path,
    max_images: int = 8,
):
    """SSOD debug mosaic: GT boxes green, pseudo labels red with scores
    (reference utils/self_supervised_utils.py:239-243 debug dumps)."""
    plt = pyplot()
    b = min(len(images), max_images)
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows),
                             squeeze=False, tight_layout=True)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= b:
            continue
        img = images[i]
        h, w = img.shape[:2]
        ax.imshow(img)
        for row, ok in zip(gt_labels[i], gt_mask[i]):
            if not ok:
                continue
            cx, cy, bw, bh = row[1] * w, row[2] * h, row[3] * w, row[4] * h
            ax.add_patch(plt.Rectangle(
                (cx - bw / 2, cy - bh / 2), bw, bh, fill=False,
                edgecolor="#2ecc71", linewidth=1.5,
            ))
        for row, ok in zip(pseudo_labels[i], pseudo_mask[i]):
            if not ok:
                continue
            cx, cy, bw, bh = row[1] * w, row[2] * h, row[3] * w, row[4] * h
            ax.add_patch(plt.Rectangle(
                (cx - bw / 2, cy - bh / 2), bw, bh, fill=False,
                edgecolor="#e74c3c", linewidth=1.2, linestyle="--",
            ))
            txt = f"{int(row[0])}"
            if len(row) > 5:
                txt += f" {row[5]:.2f}"
            ax.text(cx - bw / 2, cy - bh / 2 - 2, txt, fontsize=7,
                    color="#e74c3c")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_results(results_csv: Path, save_path: Optional[Path] = None):
    """Training curves from results.csv (reference plot_results)."""
    plt = pyplot()
    import csv as _csv

    with open(results_csv) as f:
        rows = list(_csv.reader(f))
    header, data = rows[0], np.array(
        [[float(v) if v else 0.0 for v in r] for r in rows[1:]]
    )
    if not len(data):
        return
    n = len(header) - 1
    cols = 5
    rws = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rws, cols, figsize=(3 * cols, 2.5 * rws),
                             squeeze=False, tight_layout=True)
    for j in range(1, len(header)):
        ax = axes[(j - 1) // cols][(j - 1) % cols]
        ax.plot(data[:, 0], data[:, j], marker=".")
        ax.set_title(header[j], fontsize=8)
    for j in range(n, rws * cols):
        axes[j // cols][j % cols].axis("off")
    out = save_path or Path(results_csv).with_name("results.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)


def feature_visualization(feats, path: Path, max_maps: int = 32):
    """Per-stage feature-map grids (reference utils/plots.py
    feature_visualization / yolo.py --visualize): each pyramid level's
    first `max_maps` channels as grayscale tiles.

    feats: list of (B, H, W, C) arrays (NHWC; the backbone/neck outputs).
    Writes one <path>_pN.png per level using the first batch element."""
    plt = pyplot()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    for li, f in enumerate(feats):
        f = np.asarray(f, np.float32)
        if f.ndim != 4 or f.shape[0] == 0:
            continue
        maps = f[0].transpose(2, 0, 1)[:max_maps]  # (C, H, W)
        n = len(maps)
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
        fig, axes = plt.subplots(rows, cols,
                                 figsize=(1.4 * cols, 1.4 * rows),
                                 squeeze=False, tight_layout=True)
        for i in range(rows * cols):
            ax = axes[i // cols][i % cols]
            ax.axis("off")
            if i < n:
                ax.imshow(maps[i], cmap="gray")
        fig.savefig(path.with_name(f"{path.stem}_p{li + 3}.png"), dpi=120)
        plt.close(fig)
