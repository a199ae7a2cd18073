"""Training curves and embedding scatter plots (counterpart of
``kbner_tpu/utils/plotter.py``; the reference's
``flair/visual/training_curves.py``).

``plot_training_curves`` reads a run's ``history.json`` (or ``loss.tsv``)
and writes ``training_curves.png``. matplotlib and sklearn are optional:
without them both functions return None.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional


def plot_training_curves(base_path: str | Path,
                         out_name: str = "training_curves.png"
                         ) -> Optional[Path]:
    base_path = Path(base_path)
    history_file = base_path / "history.json"
    loss_tsv = base_path / "loss.tsv"
    if history_file.exists():
        history = json.loads(history_file.read_text())
        losses = history.get("train_loss", [])
        dev = history.get("dev_score", [])
    elif loss_tsv.exists():
        losses, dev = [], []
        for line in loss_tsv.read_text().splitlines()[1:]:
            parts = line.split("\t")
            if len(parts) >= 4:
                losses.append(float(parts[2]))
                dev.append(float(parts[3]))
    else:
        return None

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(7, 6), sharex=True)
    epochs = range(1, len(losses) + 1)
    ax1.plot(epochs, losses, marker="o")
    ax1.set_ylabel("train loss")
    ax1.grid(alpha=0.3)
    ax2.plot(epochs, dev, marker="o", color="tab:green")
    ax2.set_ylabel("dev score")
    ax2.set_xlabel("epoch")
    ax2.grid(alpha=0.3)
    fig.tight_layout()
    out = base_path / out_name
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out


def plot_embedding_tsne(
    embeddings,
    labels,
    out_path: str | Path,
    perplexity: float = 5.0,
    seed: int = 0,
) -> Optional[Path]:
    """t-SNE scatter of word/span embeddings colored by label (reference
    ``flair/visual/`` tSNE plots). Requires sklearn + matplotlib."""
    import numpy as np

    try:
        from sklearn.manifold import TSNE
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    embeddings = np.asarray(embeddings)
    perplexity = min(perplexity, max(1.0, (len(embeddings) - 1) / 3))
    coords = TSNE(n_components=2, perplexity=perplexity,
                  random_state=seed, init="pca").fit_transform(embeddings)
    uniq = sorted(set(labels))
    fig, ax = plt.subplots(figsize=(7, 6))
    for i, lbl in enumerate(uniq):
        mask = np.asarray([l == lbl for l in labels])
        ax.scatter(coords[mask, 0], coords[mask, 1], label=str(lbl), s=18)
    ax.legend(fontsize=8)
    ax.set_title("embedding t-SNE")
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out
