"""Error types of the port's training loop (counterpart of
midgpt_tpu/robustness; the supervisor, preemption, watchdog and fault
plans are not ported yet — ROADMAP.md)."""
