"""Bar-chart reporting (counterpart of ``stereomatching_tpu/bench/
graphs.py``; the reference's graphing harness, test/make_graph.py +
Makefile:70-82): times per size, speedup vs a baseline series, and the
pixel-pass throughput model.  Matplotlib is optional: without it (the
GPU host has none) every function warns once and returns False, and the
graphs are rendered elsewhere from the JSON lines of ``python -m
stereomatching_tpu_torch.bench --json`` (``tools/render_graphs_torch.py``).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

from stereomatching_tpu_torch.bench.harness import BenchResult


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        warnings.warn("matplotlib unavailable; skipping graphs")
        return None


def times_graph(series: Dict[str, Sequence[BenchResult]], path: str) -> bool:
    """Grouped time bars, one group per size, one bar per tier
    (the reference's `graph` helper, test/make_graph.py:20-33)."""
    plt = _plt()
    if plt is None:
        return False
    names = list(series)
    sizes = [r.name for r in series[names[0]]]
    fig, ax = plt.subplots(figsize=(1.6 * len(sizes) + 2, 4))
    width = 0.8 / len(names)
    for j, tier in enumerate(names):
        xs = [i + j * width for i in range(len(sizes))]
        ax.bar(xs, [r.mean_s for r in series[tier]], width, label=tier)
    ax.set_xticks([i + 0.4 - width / 2 for i in range(len(sizes))])
    ax.set_xticklabels(sizes)
    ax.set_ylabel("seconds")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def speedup_graph(
    baseline: Sequence[BenchResult],
    accelerated: Sequence[BenchResult],
    path: str,
    label: str = "speedup",
) -> bool:
    """Element-wise baseline/accelerated bars (test/make_graph.py:47-48)."""
    plt = _plt()
    if plt is None:
        return False
    sizes = [r.name for r in baseline]
    sp = [b.mean_s / a.mean_s for b, a in zip(baseline, accelerated)]
    fig, ax = plt.subplots(figsize=(1.2 * len(sizes) + 2, 4))
    ax.bar(range(len(sizes)), sp)
    ax.set_xticks(range(len(sizes)))
    ax.set_xticklabels(sizes)
    ax.set_ylabel(label)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def throughput_graph(
    results: Sequence[BenchResult], path: str, title: Optional[str] = None
) -> bool:
    """Pixel-passes/second per size (test/make_graph.py:50-54)."""
    plt = _plt()
    if plt is None:
        return False
    sizes = [r.name for r in results]
    th = [r.pixels_per_s / 1e9 for r in results]
    fig, ax = plt.subplots(figsize=(1.2 * len(sizes) + 2, 4))
    ax.bar(range(len(sizes)), th)
    ax.set_xticks(range(len(sizes)))
    ax.set_xticklabels(sizes)
    ax.set_ylabel("billion pixel-passes / s")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True
