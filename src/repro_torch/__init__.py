"""PyTorch/CUDA port of the FedAttn reproduction, for NVIDIA Hopper (H100).

A second package beside the JAX reference ``repro``: it imports torch,
numpy and the standard library only — never ``jax`` and never ``repro``.
Entry points (:class:`repro_torch.serving.engine.FedAttnEngine`,
:class:`repro_torch.models.transformer.TransformerLM`,
``python -m repro_torch.launch.serve``) run on CUDA unless the caller asks
for the CPU. The CUDA kernels live in ``csrc/`` and are built with ``nvcc``
at first use (:mod:`repro_torch.kernels.build`).
"""
