"""kbner_tpu_torch — the PyTorch/CUDA port of kbner_tpu for NVIDIA Hopper.

This package serves and trains retrieval-augmented NER on one H100: BM25
retrieval over a device-resident index, exhaustive (scored by the
hand-written CUDA kernel ``csrc/bm25_score.cu``) or pruned (candidates
rescored by ``csrc/delta16_rescore.cu`` or ``csrc/bm25_rescore.cu``),
context fusion, and an XLM-R + CRF tagger with its fine-tuning trainer
(``train/``: CRF losses, two-group AdamW, Flax-compatible checkpoints).
Its layout mirrors ``kbner_tpu`` (``data/``, ``eval/``, ``retrieval/``,
``ops/``, ``models/``, ``train/``, ``cli.py``) so each module's JAX
counterpart is found by path.

It imports ``torch`` and ``numpy`` only; nothing of JAX or of
``kbner_tpu``. Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``.
"""
