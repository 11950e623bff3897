"""PyTorch/CUDA port of the ``repro`` JAX package for an NVIDIA H100.

Module names mirror ``repro`` so that each module's counterpart is easy to
find.  The package imports neither ``jax`` nor anything of ``repro``.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the hand-written kernel.
"""
