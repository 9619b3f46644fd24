"""Training launcher (counterpart of the JAX package's launch.py).

    python -m midgpt_tpu_torch.launch --config=local_text_124m [--rundir=R] \\
        [--debug] [--set key=value ...] [--device cuda|cpu]
    torchrun --standalone --nproc_per_node N -m midgpt_tpu_torch.launch \\
        --multihost --rundir=R [--backend nccl|gloo] ...

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
newest verified step. `--debug` writes no run directory, evaluates one
batch and traces the first step after the first with torch.profiler
(training/metrics.py `Profiler`: a Chrome trace under
`<tempdir>/midgpt_trace`).

`--multihost` joins the process group of the ranks torchrun started
(parallel/dist.py: NCCL for CUDA ranks, gloo for CPU ranks, or the
`--backend` named; ranks that share a card name gloo) and trains every
rank on the mesh of the config's data, fsdp, sp and tp axes
(parallel/mesh.py): data-parallel rows, FSDP-sharded weights and moments,
sequence-parallel columns (`--set mesh.sp=N --set
model_config.attn_impl=ring|ulysses`: the ring or Ulysses over each
position's N ranks), Megatron tensor-parallel rows (`--set mesh.tp=N`:
consecutive ranks at pp 1, the vocab-parallel embedding and CE under
`tp_vocab`), pipeline stages (`--set mesh.pp=N --set
pipeline_schedule=gpipe|1f1b --set pipeline_microbatches=M`: each stage
its L/N layers, parallel/pipeline.py), expert-parallel groups (`--set
mesh.ep=N` with a routed MLP: each rank n_experts/N of the experts,
parallel/tp.py EPTrain), one checkpoint written by rank 0. Without it the
run is one process on one device, and the mesh clamps to one rank (a
preset's sp, tp, pp or ep above 1 then refuses to lay out). A multi-rank
run must name its `--rundir`, as JAX's does.

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
    declared annotation where the current value is None. "none" and "null"
    are None where the field may be None (its annotation or its current
    value says so); a plain `str` field keeps the word, so
    `--set model_config.remat_policy=none` picks the 'none' policy."""
    tree: dict = {}
    for dotted_key, raw_value in pairs:
        parts = dotted_key.split(".")
        target = config
        for p in parts[:-1]:
            target = getattr(target, p)
        current = getattr(target, parts[-1])
        fields = getattr(target, "__dataclass_fields__", {})
        ann = str(fields[parts[-1]].type) if parts[-1] in fields else ""
        nullable = current is None or "Optional" in ann or "None" in ann
        if raw_value.lower() in ("none", "null") and (nullable or not isinstance(current, str)):
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
    parser.add_argument("--multihost", action="store_true",
                        help="join torchrun's process group and train on the mesh of its ranks")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="--multihost: the process group's backend (default: nccl for CUDA ranks, gloo for CPU)")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config override, e.g. --set model_config.n_layer=4",
    )
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.backend and not args.multihost:
        parser.error("--backend goes with --multihost")
    if args.multihost and args.rundir is None and not args.debug:
        parser.error("multihost runs must prespecify --rundir")

    from midgpt_tpu_torch.config import load_config, to_json
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.parallel import dist
    from midgpt_tpu_torch.parallel.mesh import run_mesh
    from midgpt_tpu_torch.robustness import preempt
    from midgpt_tpu_torch.robustness.supervisor import supervise

    started = args.multihost and not dist.initialized()  # a group the caller started stays the caller's
    device = dist.init(args.device, args.backend) if args.multihost else resolve_device(args.device)
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

    try:
        mesh = run_mesh(config, device)
        say = print if mesh.is_leader else (lambda *a, **k: None)
        if config.rundir and not config.debug and mesh.is_leader:
            os.makedirs(config.rundir, exist_ok=True)
            with open(os.path.join(config.rundir, "config.json"), "w") as f:
                f.write(to_json(config))
            print(f"Writing to {config.rundir}")
        mesh.barrier()
        say(config)
        if args.multihost:
            say(f"mesh {mesh.geometry()['axes']} over {mesh.size} rank(s), backend {dist.backend()}")
        preempt.install_handlers()
        try:
            return supervise(config, device=device, mesh=mesh)
        finally:
            preempt.reset()
    finally:
        if started:
            dist.shutdown()


if __name__ == "__main__":
    main()
