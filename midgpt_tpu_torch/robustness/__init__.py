"""Fault tolerance of the port's training loop and serving engine
(counterpart of midgpt_tpu/robustness): `supervisor.supervise` restarts a
diverged or hung run from the newest verified checkpoint, skipping the
poisoned data window after a divergence; `preempt` turns SIGTERM/SIGINT
into an emergency save at the next step boundary; `watchdog` bounds a
device sync with a deadline; `faults` injects named failures so all of it
is testable end to end on the CPU. Error types are in `errors`, the retry
schedule in `backoff`."""
