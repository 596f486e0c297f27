"""promp_tpu_torch: the PyTorch/CUDA port of promp_tpu for NVIDIA Hopper.

Same algorithms, module layout and parameter names as the JAX package
``promp_tpu``, written with PyTorch idioms: functions over tensors with an
explicit ``device`` and ``torch.Generator``, and ``torch.func`` for the
inner adaptation step and the second-order meta-gradient through it. The
point-mass rollout runs as a hand-written CUDA kernel
(``csrc/rollout_kernel.cu``, wrapped by ``ops/rollout_kernel.py``).

This package imports ``torch`` and ``numpy`` only; it never imports JAX or
``promp_tpu``.
"""
__version__ = "0.1.0"
