"""Training runtime of the port (counterpart of midgpt_tpu/training)."""
