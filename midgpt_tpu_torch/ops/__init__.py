"""Numerics layer of the port (counterpart of midgpt_tpu/ops)."""
