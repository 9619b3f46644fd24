"""Sampling and serving of the port (counterpart of midgpt_tpu/sampling)."""
