"""rag_docvqa_tpu_torch -- the PyTorch and CUDA port of rag_docvqa_tpu.

The same layout as the JAX package (`data/`, `models/`, `ops/`,
`engine/`), so each module's counterpart is found by path; each module's
docstring names it. The JAX package stays the reference the port is tested
against. The hot ops are hand-written CUDA kernels for Hopper (sm_90a) in
`csrc/`, built at first use by `kernels.py`; each has a plain PyTorch
version beside its wrapper, which runs on CPU tensors.

This package imports torch and never jax or flax. Ported so far: RAG-VT5
serving with all ten page-retrieval strategies, the reranker, the
not-answerable classifier and the visual branch (engine/rag_vt5.py), its
training with visual tokens, the LayoutT5 head and remat (training/,
train.py), evaluation (eval.py) and contrastive fine-tune (train_cl.py), the
corpus index (parallel/index.py, precompute.py), RAG-Pix2Struct and its
training loss (engine/rag_pix2struct.py, models/pix2struct.py), Hi-VT5
(models/hivt5.py), checkpoints from local files (models/loader.py), the
datasets, page images and multi-process ingest from local files (data/), the
layout detectors, and the causal-LM family: RAG with a Qwen2-family
generator and either Qwen vision tower (engine/rag_qwen.py,
models/causal_lm.py, models/qwen25_vision.py, models/qwen_vision.py), the
Gemma LLM pair reranker (engine/reranker.py) and LoRA SFT (models/lora.py,
train_lora.py).
"""

__version__ = "0.1.0"
