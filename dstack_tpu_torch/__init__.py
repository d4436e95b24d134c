"""dstack-tpu's serving path on PyTorch and CUDA (NVIDIA Hopper).

A port beside the JAX package: the module paths mirror ``dstack_tpu``'s
(``models/llama.py``, ``ops/flash.py``, ``serve/engine.py``, ...) so a
reader finds each counterpart, but nothing here imports JAX or any
``dstack_tpu`` module — what the port needs from a framework-neutral
module it keeps as its own copy.

The Pallas kernels of the JAX package become hand-written CUDA kernels
for ``sm_90a`` (``csrc/*.cu``), built with ``nvcc`` at first use. Each
kernel's module keeps a plain PyTorch version beside it: the CPU tests
run it, and ``chip_smoke.py`` holds the kernel against it on the card.
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
