"""Model stack of the port: the ``attn`` block pattern (dense GQA/MQA
transformers) with greedy decode through the hand-written kernels."""
