"""Small helpers of the port (counterpart of midgpt_tpu/utils)."""
