"""Token-stream data of the port (counterpart of midgpt_tpu/data)."""
