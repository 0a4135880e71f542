"""The port's checked-in lint allowlist: (rule, location-glob, one-line
reason).

The contract of ``paddle_tpu/analysis/allowlist.py``: deliberate
exceptions are encoded here, per rule and per file, each with its
justification — never by silencing a rule globally. Patterns match the
repo-relative file path, the full ``path:line`` location or the
diagnostic's message (fnmatch globs). Suppressed findings are still
counted and listed by ``analysis.lint`` and the CLI, so drift stays
visible; ``tests/test_torch_lint_clean.py`` keeps the port clean
against the active rules and fails on an entry that suppresses nothing.
"""

ALLOWLIST = [
    # -- PTL001: deliberate device->host reads ----------------------------
    ("PTL001", "paddle_tpu_torch/core/tensor.py",
     "the host-interop API itself: numpy/item/tolist/__array__ and the "
     "Python number conversions are reads by definition (each one "
     "reports to _sync_hook)"),
    ("PTL001", "paddle_tpu_torch/__init__.py",
     "paddle.tolist() is the public host-conversion API"),
    ("PTL001", "paddle_tpu_torch/convert.py",
     "weight conversion to and from the JAX package runs on host numpy"),
    ("PTL001", "paddle_tpu_torch/framework/io.py",
     "save/load write host bytes: the tensors go to the host by contract"),
    ("PTL001", "paddle_tpu_torch/serving_fleet.py",
     "the fleet wire carries host bytes between processes"),
    ("PTL001", "paddle_tpu_torch/io/*",
     "the data pipeline's samplers and workers handle host data (index "
     "arrays, tensors pickled across worker processes)"),
    ("PTL001", "paddle_tpu_torch/geometric/*",
     "graph sampling utilities run on host numpy by design, as in JAX"),
    ("PTL001", "paddle_tpu_torch/incubate/*",
     "ASP mask search and graph-sample khop are host-side "
     "preprocessing, as in JAX"),
    ("PTL001", "paddle_tpu_torch/vision/detection_ops.py",
     "NMS and box post-processing run on host numpy by design, as in "
     "JAX"),
    ("PTL001", "paddle_tpu_torch/hapi/*",
     "predict/summary host conversions and the callbacks' logging by "
     "contract; the train loss is fetched once an epoch, at the log "
     "boundary, outside the captured step"),
    ("PTL001", "paddle_tpu_torch/metric/*",
     "metric accumulation reports host numbers by contract"),
    ("PTL001", "paddle_tpu_torch/inference.py",
     "Predictor.run returns host arrays by contract"),
    ("PTL001", "paddle_tpu_torch/optimizer/lr.py",
     "ReduceOnPlateau decides on the host from the metric's value by "
     "contract"),
    ("PTL001", "paddle_tpu_torch/ops/creation.py",
     "Tensor-valued shapes and fill values are host-static structure"),
    ("PTL001", "paddle_tpu_torch/ops/manipulation.py",
     "Tensor-valued axes, pads and sections are host-static structure"),
    ("PTL001", "paddle_tpu_torch/ops/math.py",
     "Tensor-valued bounds and k are host-static structure"),
    ("PTL001", "paddle_tpu_torch/ops/extra_math.py",
     "the ops the JAX package runs on host numpy (histograms, index "
     "tables) read their input to the host there too"),
    ("PTL001", "paddle_tpu_torch/nn/functional/common.py",
     "a host scalar (1 - p rounded to the dtype, a CPU tensor) and "
     "Tensor-valued sizes and pads, which are host-static structure"),
    ("PTL001", "paddle_tpu_torch/nn/functional/attention.py",
     "1 - p rounded to the dtype: a CPU scalar tensor, no device read"),
    ("PTL001", "paddle_tpu_torch/nn/functional/vision.py",
     "a Tensor-valued output shape is host-static structure"),
    ("PTL001", "paddle_tpu_torch/nn/functional/extension.py",
     "class_center_sample builds its sampled set on the host, as in "
     "JAX (labels and a host key's permutation)"),
    ("PTL001", "paddle_tpu_torch/ops/kernels/grouped_matmul.py",
     "the plain version's group offsets (the kernel's CPU reference "
     "walk), never the card's path"),
    # The main path's deliberate reads (the decode step's token fetch,
    # the SOT guards' fetch, the NaN check's fetch a stride, the KV
    # writer's host indices) carry an inline ``# lint-allow: PTL001``
    # at each site, with its reason beside it: no entry here covers
    # jit/sot.py, serving.py, serving_cache.py or core/autograd.py, so
    # a new read there is a finding.

    # -- PTL003: deliberate lock-free mutations ---------------------------
    ("PTL003", "paddle_tpu_torch/core/random.py",
     "paired __enter__/__exit__ push/pop of the key-stream stack "
     "(step-thread-confined), and the forked child's one-shot drop of "
     "the parent's device states (single-threaded after fork)"),
    ("PTL003", "paddle_tpu_torch/autograd/py_layer.py",
     "paired __enter__/__exit__ push/pop of the saved-tensor-hooks "
     "stack; hook contexts are step-thread-confined"),
    ("PTL003", "paddle_tpu_torch/incubate/asp.py",
     "the ASP mask registry changes only in user-driven prune/reset "
     "calls (host preprocessing, no worker thread touches it)"),
]

# Capture-planner (PTC*) exceptions over the port's own step functions
# (capture.scan_repo_steps): the same contract as ALLOWLIST, kept apart
# because each entry is a capture-boundary decision the plan reads as
# "capture-compatible, by design".
CAPTURE_ALLOWLIST = [
    ("PTC002", "paddle_tpu_torch/serving.py*",
     "slot and block bookkeeping (pos / last_ids / active, the prefill "
     "chunk's staging buffer, speculative accept and rollback) advances "
     "BETWEEN captured programs by design: _decode_impl, the "
     "_prefill_impl buckets and the propose / verify pair are the CUDA "
     "graphs, the engine's step methods are the boundary that replays "
     "them"),
    ("PTC003", "paddle_tpu_torch/serving.py*",
     "the per-step (or per-window) token fetch and the last prefill "
     "chunk's first token ARE the decode contract: continuous batching "
     "must see each token on the host to admit and retire requests; "
     "decode_steps fetches once a window and a speculative step once "
     "for up to k + 1 tokens"),
]
