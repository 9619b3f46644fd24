"""The rank program of tests/test_torch_sp.py: every rank that
`torchrun --standalone` starts joins one gloo group (parallel/dist.py),
runs each job of the spec in order, and the leader of each job's mesh
writes what the test compares. Every rank runs every job: a mesh of
several ranks is built by the whole group (creating a process group is
collective), and the ranks outside it go on to the next job. The jobs of
tests/torch_tp_train_ranks.py (the steps against one device, remat, the
launcher) run here on sp meshes too.

    OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_sp_ranks.py SPEC.json
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import nodes  # noqa: E402
from torch_tp_train_ranks import JOBS as TP_JOBS  # noqa: E402

from midgpt_tpu_torch.config import MeshConfig, from_json  # noqa: E402
from midgpt_tpu_torch.parallel import dist  # noqa: E402
from midgpt_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from midgpt_tpu_torch.parallel.ring_attention import ring_attention  # noqa: E402
from midgpt_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: E402
from midgpt_tpu_torch.robustness import faults, preempt  # noqa: E402
from midgpt_tpu_torch.robustness.supervisor import supervise  # noqa: E402

CPU = torch.device("cpu")


def job_attention(job):
    """The ring and Ulysses on each sp group of the job: this rank's T/sp
    columns of q, k, v and the upstream gradient in, its output shard and
    gradients out (one file per rank)."""
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, sp=len(job["ranks"])), ranks=job["ranks"], device=CPU)
    if not mesh.member:
        return
    a = np.load(job["inputs"])
    Tl = a["q"].shape[2] // mesh.sp
    cols = slice(mesh.sp_index * Tl, (mesh.sp_index + 1) * Tl)
    q, k, v = (torch.from_numpy(a[n][:, :, cols].copy()).requires_grad_() for n in "qkv")
    if job["schedule"] == "ring":
        out = ring_attention(q, k, v, mesh.sp_group, job["block_size"])
    else:
        out = ulysses_attention(q, k, v, mesh.sp_group, job["block_size"])
    out.backward(torch.from_numpy(a["do"][:, :, cols].copy()))
    np.savez(f"{job['out']}.{mesh.sp_index}.npz", out=out.detach().numpy(), dq=q.grad.numpy(),
             dk=k.grad.numpy(), dv=v.grad.numpy())


def job_elastic_sp(job):
    """A straight run on mesh A against the resumes A -> B -> C (a
    `resume_reshard` ends A, a preemption ends B; B refuses the "same"
    policy first), every mesh led by rank 0: the supervisor's mesh
    history and the final losses."""
    config = from_json(job["config"])
    meshes = [make_mesh(MeshConfig(**m), ranks=r, device=CPU) for m, r in job["meshes"]]
    a, b, c = meshes
    out = {}

    def phase(mesh, **over):
        faults.clear()
        preempt.reset()
        if mesh.member:
            return supervise(config.replace(**over), device=CPU, mesh=mesh, sleep_fn=lambda s: None)

    straight = phase(a, rundir=job["straight"])
    r1 = phase(a, fault_plan=f"resume_reshard@{job['k1']}")
    try:
        phase(b, on_resume_mesh="same")
    except RuntimeError as e:
        out["refused"] = str(e)
    r2 = phase(b, on_resume_mesh="any", fault_plan=f"preempt@{job['k2']}")
    r3 = phase(c, on_resume_mesh="any")
    if dist.rank() == 0:  # the leader of all three meshes
        out.update(straight=straight["metrics"]["loss/final"],
                   preempted=[r1["metrics"].get("preempted"), r2["metrics"].get("preempted")],
                   mesh_history=r3["supervisor"]["mesh_history"], loss_final=r3["metrics"]["loss/final"])
        with open(job["out"], "w") as fh:
            json.dump(out, fh)


JOBS = {**TP_JOBS, "attention": job_attention, "elastic_sp": job_elastic_sp}


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
