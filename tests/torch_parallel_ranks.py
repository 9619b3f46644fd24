"""The rank program of tests/test_torch_parallel.py: every rank that
`torchrun --standalone` starts joins one gloo group (env://,
parallel/dist.py), runs each job of the spec in order, and the leader of
each job's mesh writes what the test compares. Every rank runs every job:
a mesh of several ranks is built by the whole group (creating a process
group is collective), and the ranks outside it go on to the next job. A
job with "local_world" runs with torchrun's node variables set as if the
group spanned WORLD_SIZE / local_world nodes.

    OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 4 \
        tests/torch_parallel_ranks.py SPEC.json
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

from midgpt_tpu_torch.config import MeshConfig, from_json
from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import param_shapes
from midgpt_tpu_torch.parallel import dist, fsdp
from midgpt_tpu_torch.parallel.data import rank_rows
from midgpt_tpu_torch.parallel.mesh import make_mesh
from midgpt_tpu_torch.robustness import faults, preempt
from midgpt_tpu_torch.robustness.supervisor import supervise
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.optim import OptState, make_optimizer
from midgpt_tpu_torch.training.train import make_train_step, state_specs, state_template, train

CPU = torch.device("cpu")


def _mesh(job, key="mesh", ranks="ranks"):
    return make_mesh(MeshConfig(**job[key]), ranks=job[ranks], device=CPU)


def full_state(config, seed: int):
    """A whole training state from a seed (params, mu, nu), the same in
    every process that asks."""
    r = np.random.default_rng(seed)
    shapes = param_shapes(config.model_config)
    draw = lambda scale: {k: torch.from_numpy((scale * r.standard_normal(s)).astype(np.float32))  # noqa: E731
                          for k, s in shapes.items()}
    return draw(0.02), draw(1e-3), draw(1e-6)


def job_step(job):
    """Train steps from whole weights on this rank's rows; the leader saves
    the losses and the gathered params and moments."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if not mesh.member:
        return
    specs = state_specs(config, mesh)
    params = fsdp.shard_tree(params_from_numpy(dict(np.load(job["weights"])), device=CPU), specs, mesh)
    opt, _ = make_optimizer(config)
    state = opt.init(params)
    step, _ = make_train_step(config, opt, mesh, specs)
    batches = np.load(job["batches"])
    losses = []
    for x, y in zip(batches["x"], batches["y"]):
        x, y = (torch.from_numpy(rank_rows(a, mesh)).long() for a in (x, y))
        params, state, loss = step(params, state, x, y)
        losses.append(loss.item())
    out = {"loss": np.asarray(losses)}
    for tag, tree in (("p", params), ("mu", state.mu), ("nu", state.nu)):
        out.update({f"{tag}.{k}": v.numpy() for k, v in fsdp.whole_tree(tree, specs, mesh).items()})
    if mesh.is_leader:
        np.savez(job["out"], **out)


def job_train(job):
    """`train` on the job's mesh into its run directory."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if mesh.member:
        train(config, device=CPU, mesh=mesh)


def job_ckpt(job):
    """A state saved by the `save` mesh, restored on each `restore` mesh and
    gathered back whole by its leader."""
    config = from_json(job["config"])
    save_mesh = _mesh(job, "save_mesh", "save_ranks")
    if save_mesh.member:
        specs = state_specs(config, save_mesh)
        params, mu, nu = (fsdp.shard_tree(t, specs, save_mesh) for t in full_state(config, job["seed"]))
        mngr = CheckpointManager(config.rundir, mesh=save_mesh, specs=specs)
        mngr.save(job["step"], {"params": params, "opt_state": OptState(3, mu, nu, 3)}, force=True)
        mngr.close()
    torch.distributed.barrier()
    for i, (mesh_cfg, ranks) in enumerate(job["restore"]):
        mesh = make_mesh(MeshConfig(**mesh_cfg), ranks=ranks, device=CPU)
        if not mesh.member:
            continue
        specs = state_specs(config, mesh)
        mngr = CheckpointManager(config.rundir, mesh=mesh, specs=specs)
        state = mngr.restore(mngr.latest_verified_step(), state_template(config), device=CPU,
                             select=lambda k, t: fsdp.shard(t, specs[k], mesh))
        out = {"shard.wte": state["params"]["wte"].numpy()}
        for tag, tree in (("p", state["params"]), ("mu", state["opt_state"].mu), ("nu", state["opt_state"].nu)):
            out.update({f"{tag}.{k}": v.numpy() for k, v in fsdp.whole_tree(tree, specs, mesh).items()})
        if mesh.is_leader:
            np.savez(f"{job['out']}_{i}.npz", **out)


def job_elastic(job):
    """The resume from 2 ranks to 1 and back to 2 against an uninterrupted
    2-rank run, and the "same" policy's refusal."""
    config = from_json(job["config"])
    two, one = _mesh(job, "mesh", "ranks2"), _mesh(job, "mesh", "ranks1")
    rundir, out = config.rundir, {}

    def phase(mesh, **over):
        faults.clear()
        preempt.reset()
        if mesh.member:
            return supervise(config.replace(**over), device=CPU, mesh=mesh, sleep_fn=lambda s: None)

    phase(two, rundir=job["straight"])
    r1 = phase(two, fault_plan=f"resume_reshard@{job['k1']}")
    try:
        phase(one, on_resume_mesh="same")
    except RuntimeError as e:
        out["refused"] = str(e)
    r2 = phase(one, on_resume_mesh="any", fault_plan=f"preempt@{job['k2']}")
    r3 = phase(two, on_resume_mesh="any")
    if two.is_leader:
        out.update(preempted=[r1["metrics"].get("preempted"), r2["metrics"].get("preempted")],
                   mesh_history=r3["supervisor"]["mesh_history"], loss_final=r3["metrics"]["loss/final"],
                   rundir=rundir)
        with open(job["out"], "w") as fh:
            json.dump(out, fh)


def job_launch(job):
    """`launch.main` with --multihost on every rank of the group; the
    leader writes what it printed."""
    from midgpt_tpu_torch import launch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.main(job["argv"])
    if dist.rank() == 0:
        with open(job["out"], "w") as fh:
            fh.write(buf.getvalue())


def job_chaos(job):
    """`chaos_train.main` in rank 0 (it starts ranks of its own); the exit
    code and the lines it printed go to the job's file."""
    if dist.rank() != 0:
        return
    from midgpt_tpu_torch.robustness import chaos_train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = chaos_train.main(job["argv"])
    with open(job["out"], "w") as fh:
        json.dump({"rc": rc, "stdout": buf.getvalue()}, fh)


JOBS = {"step": job_step, "train": job_train, "ckpt": job_ckpt, "elastic": job_elastic, "launch": job_launch,
        "chaos": job_chaos}


@contextlib.contextmanager
def nodes(local_world):
    """torchrun's node variables for a group of WORLD_SIZE / local_world
    nodes (node-major ranks), restored afterwards."""
    keys = ("LOCAL_WORLD_SIZE", "GROUP_RANK", "LOCAL_RANK")
    saved = {k: os.environ.get(k) for k in keys}
    if local_world:
        r = dist.rank()
        os.environ.update(LOCAL_WORLD_SIZE=str(local_world), GROUP_RANK=str(r // local_world),
                          LOCAL_RANK=str(r % local_world))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    dist.init("cpu")
    try:
        for job in spec["jobs"]:
            with nodes(job.get("local_world")):
                JOBS[job["kind"]](job)
        torch.distributed.barrier()
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
