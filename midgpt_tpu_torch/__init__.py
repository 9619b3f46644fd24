"""midgpt_tpu_torch — the PyTorch/CUDA port of midgpt_tpu for NVIDIA Hopper.

The JAX package (`midgpt_tpu`) is the reference; this package keeps its
module names so each counterpart is easy to find, and imports neither JAX
nor anything from `midgpt_tpu`. Ported so far: training (`launch.py`,
whose attention runs in the flash kernels of `csrc/flash_attention.cu`)
and the continuous-batching serving path (`sampling/serve.py` ServeEngine
over the paged KV cache, with speculative decoding and int8 pools), whose
paged attention runs in `csrc/paged_attention.cu` (bound in
`kernels/attention_template.py`), both with grouped-query attention and
the sliding window with sinks. ROADMAP.md lists what is still to be ported.

Importing this package imports no submodule; entry points run on CUDA
unless the caller passes `device="cpu"` (see `device.resolve_device`).
"""
