"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The port is a package of its own beside ``ray_tpu``: it imports
``torch``, numpy and the standard library only, never ``jax`` and
nothing of ``ray_tpu``.  Where it needs a host-only helper of the JAX
package it keeps its own copy (``exceptions.py``, ``core/deadlines.py``).

Layout mirrors the JAX package so counterparts are easy to find:

- ``models/llama.py``  — Llama config, params, forward, KV-cache decode
- ``models/convert.py`` — JAX (numpy) pytree <-> torch tensors
- ``ops/flash_attention.py`` + ``ops/csrc/`` — the flash-attention
  kernels for sm_90a (``flash_fwd.cu``, ``flash_bwd.cu`` and their
  Hopper primitives ``hopper.cuh``), their plain PyTorch versions, and
  the wrappers
- ``serve/llm.py`` — the dense continuous-batching ``LLMServer``
- ``tools/kernel_ab.py`` — times the kernels against another checkout's

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``core/device.py``).
"""
