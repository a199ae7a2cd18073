from .conlleval import ConllEval, conll_evaluate
from .ensemble import ensemble_predictions
from .metrics import Metric, evaluate_spans

__all__ = ["ConllEval", "conll_evaluate", "Metric", "evaluate_spans",
           "ensemble_predictions"]
