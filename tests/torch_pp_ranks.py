"""The rank program of tests/test_torch_pipeline.py: every rank that
`torchrun --standalone` starts joins one gloo group (parallel/dist.py),
runs each job of the spec in order, and the leader of each job's mesh
writes what the test compares. Every rank runs every job: a mesh of
several ranks is built by the whole group (creating a process group is
collective), and the ranks outside it go on to the next job. The jobs of
tests/torch_tp_train_ranks.py (the steps and gradients against one
device, the checkpoints, the launcher) run here on pp meshes too.

    OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_pp_ranks.py SPEC.json
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import nodes  # noqa: E402
from torch_tp_train_ranks import JOBS as TP_JOBS  # noqa: E402
from torch_tp_train_ranks import _load, _mesh  # noqa: E402

from midgpt_tpu_torch.config import from_json  # noqa: E402
from midgpt_tpu_torch.parallel import dist, fsdp, pipeline  # noqa: E402
from midgpt_tpu_torch.parallel.data import rank_rows  # noqa: E402
from midgpt_tpu_torch.parallel.tp import HEAD_REGION_LEAVES  # noqa: E402
from midgpt_tpu_torch.training.train import state_specs  # noqa: E402


def job_pipe(job):
    """The schedule's loss and reduced gradients on the job's mesh, from
    whole weights on this rank's rows of one batch: the global loss (the
    ranks' shares summed, each tp row once, over the batch positions), the
    whole gradients, the CE rows each call ran on each rank (the
    schedule's, then the eval forward's) and the schedule's stage sends."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if not mesh.member:
        return
    specs = state_specs(config, mesh)
    params = fsdp.shard_tree(_load(job, config), specs, mesh)
    params = {k: v.requires_grad_() for k, v in params.items()}
    b = np.load(job["batches"])
    x, y = (torch.from_numpy(rank_rows(b[n][0], mesh)).long() for n in ("x", "y"))
    pipe = pipeline.Pipeline(config, mesh, specs)
    rows, ce = [], pipe._ce

    def counting(shard, head, y_s):
        rows.append(shard.shape[0])
        return ce(shard, head, y_s)

    pipe._ce = counting
    pipeline.SENDS.clear()
    n_batch = mesh.token_shards
    loss, grads = pipe.loss_and_grad(params, x, y, 1.0 / n_batch)
    sends = dict(pipeline.SENDS)
    grads = dict(zip(params, grads))
    fsdp.reduce_grads(grads, specs, mesh, tp_partial=HEAD_REGION_LEAVES)
    eval_share = pipe.loss({k: v.detach() for k, v in params.items()}, x, y)
    shares = torch.stack([loss, eval_share]) * (mesh.tp_index == 0)
    total = mesh.all_reduce_(shares, mesh.group) / n_batch
    whole = fsdp.whole_tree(grads, specs, mesh)
    all_rows = [None] * mesh.size
    torch.distributed.all_gather_object(all_rows, rows, group=mesh.group)
    if mesh.is_leader:
        np.savez(job["out"], loss=total[0].numpy(), eval=total[1].numpy(), rows=np.asarray(all_rows),
                 sends=json.dumps(sends),
                 **{f"g.{k}": v.numpy() for k, v in whole.items()})


def job_stash(job):
    """1F1B's stash high-water mark on each rank at each microbatch count
    of the job (a fixed microbatch of `micro` rows)."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if not mesh.member:
        return
    specs = state_specs(config, mesh)
    params = {k: v.requires_grad_() for k, v in fsdp.shard_tree(_load(job, config), specs, mesh).items()}
    marks = {}
    r = np.random.default_rng(11)
    for M in job["microbatches"]:
        pipe = pipeline.Pipeline(config.replace(pipeline_microbatches=M, batch_size=M * job["micro"]), mesh, specs)
        x = torch.from_numpy(r.integers(0, config.model_config.vocab_size, (M * job["micro"], 32))).long()
        pipe.loss_and_grad(params, x, x.roll(-1, 1))
        marks[M] = pipeline.STASH["high_water"]
    got = [None] * mesh.size
    torch.distributed.all_gather_object(got, marks, group=mesh.group)
    if mesh.is_leader:
        with open(job["out"], "w") as fh:
            json.dump(got, fh)


JOBS = {**TP_JOBS, "pipe": job_pipe, "stash": job_stash}


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
