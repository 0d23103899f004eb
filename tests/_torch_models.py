"""Reduced model configs on which the port's serving and training tests
hold it against the reference: gemma-2b, and yi-6b and chatglm3-6b both as
``reduced()`` makes them (one KV head, G = 4) and at their real G (8 and 16
query heads over one KV head of the reduced width); the MoE family:
moonshot-v1-16b-a3b (4 experts, top-2, one shared expert) and dbrx-132b
(``layer`` norm, no shared expert) reduced, and dbrx at its real G 6; and
the plain two-layer MLP: musicgen-large (gelu, ``layer`` norm; its audio
frontend is not fed by serving or the train step) and nemotron-4-340b
(squared ReLU) reduced, and nemotron at its real G 12; phi-3-vision-4.2b
(SwiGLU, its vision frontend's ``frontend_proj`` among the parameters)
reduced."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from repro.configs import get_config

#: case -> (arch, query heads over one KV head, or None for ``reduced()``)
MODEL_CASES = {"gemma-2b": ("gemma-2b", None), "yi-6b": ("yi-6b", None),
               "yi-6b-g8": ("yi-6b", 8),
               "chatglm3-6b": ("chatglm3-6b", None),
               "chatglm3-6b-g16": ("chatglm3-6b", 16),
               "moonshot": ("moonshot-v1-16b-a3b", None),
               "dbrx": ("dbrx-132b", None), "dbrx-g6": ("dbrx-132b", 6),
               "musicgen": ("musicgen-large", None),
               "phi3v": ("phi-3-vision-4.2b", None),
               "nemotron": ("nemotron-4-340b", None),
               "nemotron-g12": ("nemotron-4-340b", 12)}


def reduced_case(case: str):
    """The reference's reduced config of ``case``."""
    arch, heads = MODEL_CASES[case]
    cfg = get_config(arch).reduced()
    if heads is None:
        return cfg
    return dataclasses.replace(cfg, name=f"{cfg.name}-g{heads}",
                               n_heads=heads, n_kv_heads=1)


def random_biases(cfg, jp, seed: int = 7):
    """The reference's fp32 parameters with chatglm3-6b's qkv biases drawn
    at random (the init leaves them at zero, which would hold nothing)."""
    if not cfg.attn_bias:
        return jp
    rng = np.random.default_rng(seed)
    attn = dict(jp["blocks"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(
            rng.standard_normal(attn[name].shape) * 0.5, jnp.float32)
    return dict(jp, blocks=dict(jp["blocks"], attn=attn))
