"""PyTorch/CUDA port of the ``repro`` package (GWT optimizer + LLaMA trainer).

The JAX package ``repro`` is the reference; this package keeps its module
layout so each counterpart is easy to find.  It imports ``torch``, numpy and
the standard library only — never ``jax`` and never ``repro``.

Device rule: an entry point runs on CUDA unless the caller asks for the CPU.
A kernel wrapper dispatches on the tensor's device alone — a CUDA tensor
launches the hand-written kernel (and raises if it cannot), a CPU tensor
takes the plain PyTorch version.
"""
