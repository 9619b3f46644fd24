"""midgpt_tpu_torch — the PyTorch/CUDA port of midgpt_tpu for NVIDIA Hopper.

The JAX package (`midgpt_tpu`) is the reference; this package keeps its
module names so each counterpart is easy to find, and imports neither JAX
nor anything from `midgpt_tpu`. Ported so far: the continuous-batching
serving path (`sampling/serve.py` ServeEngine over the paged KV cache),
whose decode attention runs in a hand-written CUDA kernel
(`csrc/paged_attention.cu`, bound in `kernels/attention_template.py`).
ROADMAP.md lists what is still to be ported.

Importing this package imports no submodule; entry points run on CUDA
unless the caller passes `device="cpu"` (see `device.resolve_device`).
"""
