"""rag_docvqa_tpu_torch -- the PyTorch and CUDA port of rag_docvqa_tpu.

The same layout as the JAX package (`data/`, `models/`, `ops/`,
`engine/`), so each module's counterpart is found by path; each module's
docstring names it. The JAX package stays the reference the port is tested
against. The hot ops are hand-written CUDA kernels for Hopper (sm_90a) in
`csrc/`, built at first use by `kernels.py`; each has a plain PyTorch
version beside its wrapper, which runs on CPU tensors.

This package imports torch and never jax or flax. Ported so far: RAG-VT5
serving with the `concat` and `oracle` strategies (engine/rag_vt5.py).
"""

__version__ = "0.1.0"
