"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port runs on an NVIDIA Hopper card (H100) and keeps the JAX
package's module names, so each module here has a counterpart of the
same name in ``paddle_tpu``. This slice carries the paged-KV Llama
serving path:

- ``models.llama`` — ``LlamaConfig`` and the ``LlamaForCausalLM``
  module tree (same parameter names as the JAX model);
- ``convert`` — carries JAX weights across as numpy;
- ``serving_cache`` — the paged KV block pool, its radix prefix tree
  and the ``paged_attention`` seam;
- ``serving`` — the dense and paged decode engines and the
  ``GenerationServer``;
- ``ops.kernels`` — the hand-written Hopper paged-attention kernel,
  its plain PyTorch walk and the ``nvcc`` build.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without that argument it raises.
Importing this package imports no submodule (and never JAX).
"""
