"""See the package docstring of rag_docvqa_tpu_torch."""
