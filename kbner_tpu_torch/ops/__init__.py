"""Device ops: BM25 scoring (CUDA kernels with plain twins), CRF and tree
CRF, distillation losses (the package surface of ``kbner_tpu.ops``:
``bm25_score_block`` is the reference's ``bm25_score_block_pallas``,
``bm25_score_block_ref`` its ``bm25_score_block_xla``). Importing it
builds nothing: each kernel builds at its first launch."""
from .crf import (
    crf_decode,
    crf_forward,
    crf_gold_score,
    crf_marginals,
    crf_neg_log_likelihood,
)
from .bm25 import (
    bm25_pruned_topk,
    bm25_pruned_topk_packed,
    bm25_score_block,
    bm25_score_block_ref,
    bm25_topk,
    merge_topk,
)
from .tree_crf import (
    tree_crf_inside,
    tree_crf_loss,
    tree_crf_marginals,
)
from .losses import (
    distillation_loss,
    feature_l2_loss,
    multi_view_loss,
    posterior_distillation_loss,
    token_ce_entropy_loss,
)

__all__ = [
    "crf_forward",
    "crf_gold_score",
    "crf_neg_log_likelihood",
    "crf_decode",
    "crf_marginals",
    "bm25_score_block_ref",
    "bm25_score_block",
    "bm25_topk",
    "bm25_pruned_topk",
    "bm25_pruned_topk_packed",
    "merge_topk",
    "tree_crf_inside",
    "tree_crf_loss",
    "tree_crf_marginals",
    "distillation_loss",
    "posterior_distillation_loss",
    "multi_view_loss",
    "feature_l2_loss",
    "token_ce_entropy_loss",
]
