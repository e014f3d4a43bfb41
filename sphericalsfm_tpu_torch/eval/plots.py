"""Figure artifacts of the solver evaluation — port of
`sphericalsfm_tpu/eval/plots.py`: noise-response curves and per-solver box
plots, the zero-noise stability KDE, and the full-RANSAC error box plots,
rendered from the experiments' in-memory results. matplotlib (Agg) is
imported only when a figure is drawn, so the experiments run without it
and a figure asked for without it raises ImportError.
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def _finite(x):
    x = np.asarray(x, np.float64).ravel()
    return x[np.isfinite(x)]


METRIC_LABELS = {
    "frob": "Frobenius error",
    "rot": "Rotation error (deg)",
    "trans": "Translation error (deg)",
}


def plot_noise_curves(noises_px, samples, out_dir) -> list[str]:
    """Median-vs-noise curves, one figure per metric, one line per solver.

    `samples[solver][metric]` is a list over noise levels of per-trial error
    arrays. Returns the written paths.
    """
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for metric, ylabel in METRIC_LABELS.items():
        fig, ax = plt.subplots(figsize=(7, 3.2))
        for solver, per_metric in samples.items():
            meds = [float(np.median(_finite(a))) if _finite(a).size else np.nan
                    for a in per_metric[metric]]
            ax.plot(noises_px, meds, marker="o", markersize=3, label=solver)
        ax.set_xlabel("observation noise (px)")
        ax.set_ylabel(f"median {ylabel}")
        ax.legend(fontsize=8)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{metric}_noise.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        paths.append(path)
    return paths


def plot_noise_boxes(noises_px, samples, out_dir) -> list[str]:
    """Per-solver box plots of the error distribution at each noise level
    (full whiskers, like the reference's whis=(0,100) figures)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for solver, per_metric in samples.items():
        for metric, ylabel in METRIC_LABELS.items():
            data = [_finite(a) for a in per_metric[metric]]
            data = [d if d.size else np.asarray([np.nan]) for d in data]
            fig, ax = plt.subplots(figsize=(7, 3.2))
            ax.boxplot(data, whis=(0, 100))
            ax.set_xticks(range(1, len(noises_px) + 1))
            ax.set_xticklabels([f"{n:g}" for n in noises_px])
            ax.set_xlabel("observation noise (px)")
            ax.set_ylabel(ylabel)
            ax.set_title(solver)
            fig.tight_layout()
            path = os.path.join(out_dir, f"box_{metric}_{solver}.png")
            fig.savefig(path, dpi=120)
            plt.close(fig)
            paths.append(path)
    return paths


def plot_stability_kde(log10_by_solver, out_png,
                       bins=np.linspace(-16, 0, 512)) -> str:
    """Zero-noise numerical-stability figure: Gaussian KDE of the log10
    Frobenius error per solver (the reference's stability_frob.png)."""
    from scipy.stats import gaussian_kde

    plt = _plt()
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(3.5, 2.5))
    for solver, vals in log10_by_solver.items():
        vals = _finite(vals)
        if vals.size < 2 or np.ptp(vals) < 1e-12:
            continue
        ax.plot(bins, gaussian_kde(vals)(bins), label=solver)
    ax.set_xlabel("log(error)")
    ax.set_ylabel("density")
    ax.set_title("Log Frobenius norm")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_ransac_boxes(samples_by_method, out_dir) -> list[str]:
    """Full-RANSAC error box plots, one figure per metric with one box per
    method column (the reference's {mode}_ransac_{metric}.png figures)."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    metrics = next(iter(samples_by_method.values())).keys()
    for metric in metrics:
        labels = list(samples_by_method.keys())
        data = [_finite(samples_by_method[m][metric]) for m in labels]
        data = [d if d.size else np.asarray([np.nan]) for d in data]
        fig, ax = plt.subplots(figsize=(7, 3.2))
        ax.boxplot(data, tick_labels=labels, whis=(0, 100))
        ax.set_ylabel(METRIC_LABELS.get(metric, metric))
        fig.tight_layout()
        path = os.path.join(out_dir, f"ransac_{metric}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        paths.append(path)
    return paths
