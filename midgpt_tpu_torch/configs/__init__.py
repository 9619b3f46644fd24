"""Named experiment presets of the port (counterpart of midgpt_tpu/configs):
each module exposes a module-level `config` (config.load_config)."""
