"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The port is a package of its own beside ``ray_tpu``: it imports
``torch``, numpy and the standard library only, never ``jax`` and
nothing of ``ray_tpu``.  Where it needs a host-only helper of the JAX
package it keeps its own copy (``exceptions.py``, ``core/deadlines.py``).

Layout mirrors the JAX package so counterparts are easy to find:

- ``models/llama.py``  — Llama config, params, forward, KV-cache decode
- ``models/convert.py`` — JAX (numpy) pytree <-> torch tensors
- ``ops/flash_attention.py`` + ``ops/csrc/flash_fwd.cu`` — flash forward
  kernel for sm_90a, its plain PyTorch version, and the wrappers
- ``serve/llm.py`` — the dense continuous-batching ``LLMServer``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``core/device.py``).
"""
