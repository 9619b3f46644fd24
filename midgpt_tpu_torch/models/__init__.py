"""Model definitions of the port (counterpart of midgpt_tpu/models)."""
