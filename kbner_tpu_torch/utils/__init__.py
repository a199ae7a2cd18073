"""Artifacts, HTML views of entity spans, plots and progress logs
(counterpart of ``kbner_tpu/utils``)."""

from .plotter import plot_training_curves

__all__ = ["plot_training_curves"]
