"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterpart of midgpt_tpu/kernels). Sources live in midgpt_tpu_torch/csrc;
`build.py` compiles them with nvcc at first use."""
