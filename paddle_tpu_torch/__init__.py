"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port runs on an NVIDIA Hopper card (H100) and keeps the JAX
package's module names, so each module here has a counterpart of the
same name in ``paddle_tpu``. Four slices are ported.

Serving (paged-KV Llama):

- ``models.llama`` — ``LlamaConfig`` and the ``LlamaForCausalLM``
  module tree (same parameter names as the JAX model);
- ``convert`` — carries JAX weights (and optimizer state) across as
  numpy;
- ``serving_cache`` — the paged KV block pool, its radix prefix tree
  and the ``paged_attention`` seam;
- ``serving`` — the dense and paged decode engines and the
  ``GenerationServer``;
- ``ops.kernels.paged_attention`` — the hand-written Hopper
  paged-attention kernel and its plain PyTorch walk;
- ``serving_supervisor`` — the admission policies, the supervised
  decode loop (crash and stall recovery) and canary ``rollout``;
- ``framework`` — ``save`` / ``load`` and the crash-safe checkpoints
  (``CheckpointManager``) in the JAX package's file format;
- ``observability`` — metrics, the flight recorder with its dumps and
  crash hooks, and their CLI; ``utils.fault_injection`` and
  ``utils.backoff``.

Training (Llama with AdamW):

- ``ops.kernels.flash_attention`` — the hand-written Hopper flash
  attention forward, dQ and dK/dV kernels, their plain versions and
  the ``FlashAttention`` autograd function;
- ``nn.functional`` — the paddle attention entries;
- ``ops.fused_ce`` — the chunked fused cross-entropy;
- ``optimizer`` — ``Adam`` and ``AdamW``;
- ``jit`` — ``TrainStep``;
- ``ops.kernels.build`` — the ``nvcc`` build of every kernel source.

BERT-base MLM training (dropout inside and around attention):

- ``models.bert`` — ``BertConfig`` and ``BertForMaskedLM`` (same
  parameter names as the JAX model);
- ``nn`` — ``TransformerEncoder``/``TransformerEncoderLayer``/
  ``MultiHeadAttention``, ``LayerNorm``, ``Dropout``,
  ``CrossEntropyLoss``; ``nn.functional`` — ``dropout`` (the JAX hash
  mask), ``gelu``, ``tanh``, ``layer_norm``, ``cross_entropy`` and the
  packed-varlen entry ``flash_attn_varlen_qkvpacked``;
- ``core.random`` — the port's generator and the seeds it draws for
  the kernels' Philox dropout and the hash dropout;
- ``ops.kernels.flash_attention`` again — attention dropout (the
  Philox keep mask) and segment (varlen) masking inside the same
  kernels.

ERNIE-MoE training and the grouped-matmul op:

- ``models.ernie_moe`` — ``ErnieMoEConfig`` and ``ErnieMoEForCausalLM``
  (same parameter names as the JAX model); ``models.gpt`` —
  ``GPTConfig`` and ``GPTAttention`` (causal flash attention);
- ``incubate.moe`` — ``MoELayer`` and its naive, Switch and GShard
  gates; ``incubate.moe_dispatch`` — the capacity dispatch tables and
  the index forward;
- ``ops.kernels.grouped_matmul`` — the ``grouped_matmul`` op, the
  hand-written Hopper grouped-matmul kernels (forward and dlhs; drhs),
  their plain versions and the ``GroupedMatmul`` autograd function;
- ``convert`` again — the expert stacks and gate weights copied as
  they are.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA and without that argument it raises.
Importing this package imports no submodule (and never JAX):
``paddle_tpu_torch.save`` / ``load`` bind ``framework.io``'s on first
use.
"""

__all__ = ["save", "load"]


def __getattr__(name):
    if name in ("save", "load"):
        from .framework import io
        return getattr(io, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
