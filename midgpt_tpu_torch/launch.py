"""Training launcher (counterpart of the JAX package's launch.py).

    python -m midgpt_tpu_torch.launch --config=local_text_124m [--rundir=R] \\
        [--debug] [--set key=value ...] [--device cuda|cpu]

Loads a named preset (midgpt_tpu_torch/configs), applies the dotted
`--set` overrides in one rebuild, writes `config.json` to the run
directory (default: a timestamped directory under outputs/, none with
--debug), installs the SIGTERM/SIGINT preemption handlers
(robustness/preempt.py) and trains on one device (CUDA unless `--device
cpu`) under the run supervisor (robustness/supervisor.py), with
`metrics.jsonl` beside it. Every `eval_interval` steps and at the end the
state is checkpointed into a step directory `R/<step>/`
(training/checkpoint.py), which `python -m midgpt_tpu_torch.sample
--ckpt_dir=R` serves. A rerun into the same `--rundir` resumes from the
newest verified step. `--debug` writes nothing.

The supervisor rolls a divergence back to the newest verified step with
the poisoned data window skipped, and restarts a hung step, up to
`max_restarts` times (`restart_backoff_sec` apart, doubling); its ledger is
`R/supervisor_state.json`. A SIGTERM or SIGINT makes one emergency save at
the next step boundary (within `preempt_grace_s`, if set) and a clean exit
(code 0); a second one reaches the previous handler. `watchdog_deadline_s >
0` bounds every loss sync: an expiry dumps `R/flight_recorder.json` and
`.prom` and restarts the step (`watchdog_escalate=raise`) or exits with code
17 (`exit`: the path for a really wedged device). `--set fault_plan=...`
or MIDGPT_FAULTS injects faults (robustness/faults.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from datetime import datetime


def apply_overrides(config, pairs):
    """Apply all `--set dotted.key=value` overrides in ONE rebuild.

    Each touched dataclass is replaced exactly once with every override it
    receives, so cross-field validation (__post_init__) sees the final
    state. Values parse by the current value's type, or by the field's
    declared annotation where the current value is None."""
    tree: dict = {}
    for dotted_key, raw_value in pairs:
        parts = dotted_key.split(".")
        target = config
        for p in parts[:-1]:
            target = getattr(target, p)
        current = getattr(target, parts[-1])
        fields = getattr(target, "__dataclass_fields__", {})
        ann = str(fields[parts[-1]].type) if parts[-1] in fields else ""
        if raw_value.lower() in ("none", "null"):
            value = None
        elif isinstance(current, bool) or "bool" in ann:
            value = raw_value.lower() in ("1", "true", "yes")
        elif raw_value.lower() in ("true", "false"):
            value = raw_value.lower() == "true"
        elif current is not None:
            value = type(current)(raw_value)
        elif "int" in ann:
            value = int(raw_value)
        elif "float" in ann:
            value = float(raw_value)
        else:
            value = raw_value
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def rebuild(obj, node):
        kwargs = {
            k: rebuild(getattr(obj, k), v) if isinstance(v, dict) else v
            for k, v in node.items()
        }
        return dataclasses.replace(obj, **kwargs)

    return rebuild(config, tree)


def main(argv=None) -> dict:
    """Parse the command line and train under the supervisor; returns
    `supervise`'s result. The preemption handlers are restored when it
    returns, so an in-process caller keeps its own."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--rundir", type=str)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config override, e.g. --set model_config.n_layer=4",
    )
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.multihost:
        raise NotImplementedError(
            "multi-host training is not ported yet (ROADMAP.md port queue: parallelism)"
        )

    from midgpt_tpu_torch.config import load_config, to_json
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.robustness import preempt
    from midgpt_tpu_torch.robustness.supervisor import supervise

    device = resolve_device(args.device)
    config = load_config(args.config)
    if args.set:
        config = apply_overrides(config, [kv.partition("=")[::2] for kv in args.set])
    if args.rundir is not None:
        config = config.replace(rundir=args.rundir)
    elif not args.debug:
        stamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        config = config.replace(rundir=os.path.abspath(os.path.join("outputs", stamp)))
    if args.debug:
        config = config.replace(debug=True)

    if config.rundir and not config.debug:
        os.makedirs(config.rundir, exist_ok=True)
        with open(os.path.join(config.rundir, "config.json"), "w") as f:
            f.write(to_json(config))
        print(f"Writing to {config.rundir}")
    print(config)
    preempt.install_handlers()
    try:
        return supervise(config, device=device)
    finally:
        preempt.reset()


if __name__ == "__main__":
    main()
