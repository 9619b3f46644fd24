"""Training chaos tool: injected faults against the real recovery paths of
a supervised multi-rank run, one JSON summary line (the training mode of
the JAX package's tools/chaos_run.py, :1-60 and :220-330).

    python -m midgpt_tpu_torch.robustness.chaos_train --config=local_text_124m \\
        --rundir=R --fault resume_reshard@2 --fault resume_reshard@4 \\
        [--nproc 2] [--device cpu] [--backend gloo] [--set key=value ...] [--max-restarts N]

The tool is the parent of the ranks: it starts `--nproc` rank processes
on one node (a FileStore in a temporary directory joins them,
parallel/dist.py), each of which runs `supervise` on the mesh of its
ranks with the fault plan armed, and reads the leader's result. Every
line the runs print goes to stderr; stdout carries the summary alone.

`resume_reshard@k` ends the run like a preemption at data step k (an
emergency checkpoint, exit 0). The tool then plays the scheduler, as
JAX's does with devices: it restarts the run on HALF the ranks with
on_resume_mesh="any", and, if that run is ended by a reshard again, on
all of them, alternating, at most four times. Under tensor, sequence,
pipeline and expert parallelism (`--set mesh.tp=N`, `--set mesh.sp=S`,
`--set mesh.pp=P`, `--set mesh.ep=X`) a batch position's S x N x P x X
block of ranks stays whole: half the ranks is rounded down to whole
blocks, so the reshard changes the data count with sp, tp, pp and ep
fixed, and a reshard that cannot leave whole blocks (`--nproc` below
2SNPX) is refused before any rank starts. A fault consumed stays
consumed: each restart arms only the part of the plan that has not fired
(`resume_reshard@2 --fault resume_reshard@4` on 2 ranks: 2 ranks, then 1,
then 2 again). The checkpoint holds whole leaves and the batch order is
positional, so the trajectory continues across the rank counts.

`hang_step`, `ckpt_enospc` and `resume_reshard` (with
`--set watchdog_deadline_s=...` for the hang) add JAX's `train_chaos`
fields: `detected_at_ms` (the first firing of one of them, from the
tool's start), `restarts` (the supervisor's plus the tool's),
`final_mesh`, `n_devices_final`, and `loss_parity`: the final loss
against an unfaulted run of the same config on the final rank count, in
`<rundir>_ref`, at PARITY_RTOL for the run's compute dtype and atol
1e-6. In float32 that is JAX's rtol of 1e-5 (reassociation only). In
bfloat16 it is 1e-3: the port rounds and sums the bf16 gradients in an
order that follows the rank count, and Adam's normalised update amplifies
that; the single-device trainer in bf16 alone moves its loss past 1e-5
relative in four steps when only the microbatch split changes, see
tests/test_torch_parallel.py::test_reduction_order_alone_moves_the_loss.
The ranks run on CUDA (one card each, or `--backend gloo` to share cards)
unless `--device cpu`. Serving kinds belong to `chaos_serve`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import typing as tp

TRAIN_CHAOS_KINDS = ("hang_step", "ckpt_enospc", "resume_reshard")
# the kinds whose hooks are in the training loop and the checkpoint writer
TRAIN_KINDS = ("nan_grad", "ckpt_io_error", "kill_mid_save", "truncate_ckpt_item", "preempt", *TRAIN_CHAOS_KINDS)
MAX_RESHARDS = 4
# loss_parity's bounds: rtol by compute dtype (module docstring), atol
PARITY_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
PARITY_ATOL = 1e-6


def _spec_of(f) -> str:
    return f"{f.kind}{'' if f.step is None else f'@{f.step}'}*{f.times}"


def _rank_main(args) -> int:
    """One rank of a run: join the group, supervise, and (the leader)
    write the result the parent reads."""
    from midgpt_tpu_torch.config import from_json
    from midgpt_tpu_torch.parallel import dist
    from midgpt_tpu_torch.parallel.mesh import run_mesh
    from midgpt_tpu_torch.robustness import faults, preempt
    from midgpt_tpu_torch.robustness.supervisor import supervise

    with open(args.rank_of) as fh:
        config = from_json(fh.read())
    device = dist.init(args.device, args.backend)
    try:
        mesh = run_mesh(config, device)
        fired_at: tp.Dict[str, float] = {}
        faults.set_on_fire(lambda f: fired_at.setdefault(f.kind, time.time()))
        preempt.install_handlers()
        status, error, result = "ok", None, None
        try:
            result = supervise(config, device=device, mesh=mesh)
        except (RuntimeError, FloatingPointError) as e:
            # budget exhaustion / unrecoverable divergence: the chaos result
            status, error = "failed", str(e)
        if mesh.is_leader:
            out = {
                "status": status, "error": error, "fired_at": fired_at,
                "faults_fired": faults.fired_counts(),
                "faults_left": [_spec_of(f) for f in faults.active() if f.times > 0],
                "mesh": mesh.geometry(),
            }
            if result is not None:
                out.update({
                    "supervisor": {k: v for k, v in result["supervisor"].items() if k != "faults_fired"},
                    "loss_final": result["metrics"].get("loss/final"),
                    "preempted": bool(result["metrics"].get("preempted", False)),
                })
            with open(args.out, "w") as fh:
                json.dump(out, fh)
        return 0
    finally:
        preempt.reset()
        dist.shutdown()


def run_ranks(config, n: int, *, device: tp.Optional[str], backend: tp.Optional[str]) -> dict:
    """Run `config` supervised on `n` rank processes; returns the leader's
    result. A rank that exits non-zero fails the run (RuntimeError)."""
    from midgpt_tpu_torch.config import to_json

    with tempfile.TemporaryDirectory(prefix="midgpt_chaos_train_") as tmp:
        cfg_path, out_path = os.path.join(tmp, "config.json"), os.path.join(tmp, "result.json")
        with open(cfg_path, "w") as fh:
            fh.write(to_json(config))
        argv = [sys.executable, "-m", "midgpt_tpu_torch.robustness.chaos_train", "--rank-of", cfg_path,
                "--out", out_path]
        argv += ["--device", device] if device else []
        argv += ["--backend", backend] if backend else []
        procs = []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                       GROUP_RANK="0", MIDGPT_DIST_FILE=os.path.join(tmp, "store"))
            procs.append(subprocess.Popen(argv, env=env, stdout=2))  # the ranks print to stderr
        codes = [p.wait() for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes} on {n} rank(s)")
        with open(out_path) as fh:
            return json.load(fh)


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=str)
    ap.add_argument("--rundir", type=str)
    ap.add_argument("--fault", action="append", default=[], metavar="KIND[@STEP][*TIMES]",
                    help="fault to inject (repeatable) — robustness/faults.py")
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="dotted config override (as the launcher's)")
    ap.add_argument("--nproc", type=int, default=2, help="ranks of the first run")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the ranks' backend (default: nccl for CUDA ranks, gloo for CPU)")
    ap.add_argument("--rank-of", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of:
        return _rank_main(args)

    from midgpt_tpu_torch.config import load_config
    from midgpt_tpu_torch.device import device_label, resolve_device
    from midgpt_tpu_torch.launch import apply_overrides
    from midgpt_tpu_torch.robustness import faults

    if args.config is None or args.rundir is None:
        ap.error("--config and --rundir are required")
    kinds = []
    for spec in args.fault:
        m = faults._PLAN_RE.match(spec.strip())
        kinds.append(m.group("kind") if m else spec)
        if m is None or kinds[-1] not in TRAIN_KINDS:
            ap.error(f"unknown training fault spec {spec!r} (want KIND[@STEP][*TIMES]); training kinds: "
                     f"{', '.join(TRAIN_KINDS)} (serving kinds: robustness/chaos_serve.py)")
    label = device_label(resolve_device(args.device))
    config = load_config(args.config)
    if args.set:
        config = apply_overrides(config, [kv.partition("=")[::2] for kv in args.set])
    config = config.replace(rundir=os.path.abspath(args.rundir), fault_plan=",".join(args.fault))
    if args.max_restarts is not None:
        config = config.replace(max_restarts=args.max_restarts)
    train_chaos = bool(set(kinds) & set(TRAIN_CHAOS_KINDS))
    n_tp, n_sp, n_pp, n_ep = (max(1, getattr(config.mesh, ax)) for ax in ("tp", "sp", "pp", "ep"))
    block = n_sp * n_tp * n_pp * n_ep  # a batch position's ranks
    axes = f"mesh.sp={n_sp} x mesh.tp={n_tp} x mesh.pp={n_pp} x mesh.ep={n_ep}"
    if args.nproc % block:
        ap.error(f"--nproc {args.nproc} does not hold whole sp x tp x pp x ep blocks of {axes}")
    half = max(block, args.nproc // 2 // block * block)  # the scheduler's half, in whole blocks
    if block > 1 and "resume_reshard" in kinds and half == args.nproc:
        ap.error(f"resume_reshard under {axes} needs --nproc >= {2 * block}: the reshard keeps whole sp x tp x pp x "
                 "ep blocks and changes the data count")

    t0 = time.time()
    run = lambda cfg, n: run_ranks(cfg, n, device=args.device, backend=args.backend)  # noqa: E731
    status, error, result, n = "ok", None, None, args.nproc
    fired_at: tp.Dict[str, float] = {}
    fired: tp.Dict[str, int] = {}
    reshards = 0
    try:
        with contextlib.redirect_stdout(sys.stderr):
            result = run(config, n)
            while True:
                for k, t in result["fired_at"].items():
                    fired_at.setdefault(k, t)
                for k, c in result["faults_fired"].items():
                    fired[k] = fired.get(k, 0) + c
                if not (result.get("preempted") and "resume_reshard" in fired_at and reshards < MAX_RESHARDS):
                    break
                # the scheduler's move: half the ranks, then all of them again
                n = half if reshards % 2 == 0 else args.nproc
                reshards += 1
                result = run(config.replace(on_resume_mesh="any", fault_plan=",".join(result["faults_left"])), n)
        if result["status"] != "ok":
            status, error = "failed", result["error"]
    except RuntimeError as e:
        status, error = "failed", str(e)
    summary: tp.Dict[str, tp.Any] = {
        "tool": "chaos_run", "config": args.config, "rundir": config.rundir, "status": status,
        "wall_s": round(time.time() - t0, 3), "faults_requested": args.fault, "faults_fired": fired,
        "device": label,
    }
    if result is not None and "supervisor" in result:
        summary["supervisor"] = result["supervisor"]
        summary["loss_final"] = result["loss_final"]
        summary["preempted"] = result["preempted"]
    if train_chaos:
        import numpy as np

        summary["bench"] = "train_chaos"
        times = [fired_at[k] for k in TRAIN_CHAOS_KINDS if k in fired_at]
        summary["detected_at_ms"] = round((min(times) - t0) * 1000.0, 1) if times else None
        summary["restarts"] = (int(summary["supervisor"]["restarts"]) if "supervisor" in summary else 0) + reshards
        if result is not None:
            summary["final_mesh"] = result["mesh"]
            summary["n_devices_final"] = result["mesh"]["n_devices"]
        loss_parity = False
        if status == "ok" and summary.get("loss_final") is not None:
            # an unfaulted run of the same config on the final rank count
            cfg_ref = config.replace(rundir=config.rundir + "_ref", fault_plan="", on_resume_mesh="any")
            with contextlib.redirect_stdout(sys.stderr):
                ref = run(cfg_ref, n)
            summary["loss_ref"] = ref_loss = ref.get("loss_final")
            loss_parity = bool(
                ref_loss is not None and np.isfinite(summary["loss_final"])
                and np.allclose(summary["loss_final"], ref_loss, rtol=PARITY_RTOL[config.compute_dtype],
                                atol=PARITY_ATOL)
            )
        summary["loss_parity"] = loss_parity
    if error is not None:
        summary["error"] = error
    print(json.dumps(summary))
    return 0 if status == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
