"""Fleet replica worker process (the port's counterpart of
tools/fleet_worker.py), started by `sampling/fleet_proc.py` `spawn_worker`:

    python -m midgpt_tpu_torch.sampling.fleet_worker --spec-json '{"model": {...}, "seed": 0, ...}' [--port 0]

Builds one ServeEngine (its own CUDA context, pool and host-RAM SpillTier)
and serves the framed socket protocol until drained (SIGTERM sets the
preemption flag), told bye, orphaned, or SIGKILLed (`proc_kill9`).

The spec: {model (GPTConfig fields), seed, engine (ServeEngine keywords and
cache_dtype), device, torch_config (fleet_proc.parent_torch_config)[,
threads][, param_dtype][, params_npz]}. `device` goes through
`resolve_device`: the card unless the spec says "cpu", and without CUDA it
raises. `torch_config` is applied before anything is built, `threads` pins
torch's CPU threads (one keeps CPU workers cheap beside each other).

Stdout carries exactly one line, "PORT <n>", for the spawner; everything
else goes to stderr. No `torch.distributed`: nothing here is a collective.
"""

import argparse
import contextlib
import json
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spec-json", required=True,
                    help="JSON spec: {model, seed, engine, device, torch_config[, threads][, param_dtype][, params_npz]}")
    ap.add_argument("--port", type=int, default=0, help="listen port (default 0: ephemeral, announced on stdout)")
    args = ap.parse_args()
    spec = json.loads(args.spec_json)
    out = sys.stdout

    def announce(port: int) -> None:
        print(f"PORT {port}", file=out, flush=True)

    with contextlib.redirect_stdout(sys.stderr):
        import torch

        from midgpt_tpu_torch.sampling.fleet_proc import apply_torch_config, run_worker

        if spec.get("threads"):
            torch.set_num_threads(int(spec["threads"]))
        apply_torch_config(spec.get("torch_config", {}))
        run_worker(spec, port=args.port, announce=announce)


if __name__ == "__main__":
    main()
