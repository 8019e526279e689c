"""PyTorch + CUDA port of ``multimodalsimilar_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package so each counterpart is easy to find.
The port imports torch, numpy and the standard library only; it never
imports JAX or the JAX package. Entry points take ``device=`` and default
to ``"cuda"``: without a card they raise unless the caller passes
``device="cpu"``.
"""
