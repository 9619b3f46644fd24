"""The rank program of tests/test_torch_ep.py: every rank that
`torchrun --standalone` starts joins one gloo group (parallel/dist.py),
runs each job of the spec in order, and the leader of each job's mesh
writes what the test compares. Every rank runs every job: a mesh of
several ranks is built by the whole group (creating a process group is
collective), and the ranks outside it go on to the next job. The jobs of
tests/torch_tp_train_ranks.py (the steps and gradients against one
device, the checkpoints, the launcher, chaos_train) run here on ep meshes
too.

    OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_ep_ranks.py SPEC.json
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import nodes  # noqa: E402
from torch_tp_train_ranks import JOBS as TP_JOBS  # noqa: E402
from torch_tp_train_ranks import _mesh  # noqa: E402

from midgpt_tpu_torch.config import from_json  # noqa: E402
from midgpt_tpu_torch.models.gpt import GPT, param_shapes  # noqa: E402
from midgpt_tpu_torch.parallel import dist  # noqa: E402
from midgpt_tpu_torch.parallel.tp import EPTrain  # noqa: E402
from midgpt_tpu_torch.training.train import state_specs  # noqa: E402


def job_moe_mlp(job):
    """The routed MLP of one layer on the job's ep mesh (the rank's
    experts, EPTrain's f and g) against the whole MLP on the same inputs:
    its output, the aux term, and the gradients into h, the router and the
    rank's experts, for a loss that weighs every output entry."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if not mesh.member:
        return
    cfg = config.model_config
    specs = state_specs(config, mesh)
    r = np.random.default_rng(7)
    whole = {k[len("blocks."):]: torch.from_numpy((0.3 * r.standard_normal(s[1:])).astype(np.float32))
             for k, s in param_shapes(cfg).items() if k.startswith("blocks.mlp.")}
    h = torch.from_numpy(r.standard_normal((2, 5, cfg.n_embd)).astype(np.float32))
    weight = torch.from_numpy(r.standard_normal((2, 5, cfg.n_embd)).astype(np.float32))
    ep = EPTrain(mesh, specs)
    E = cfg.n_experts // mesh.ep
    mine = slice(mesh.ep_index * E, (mesh.ep_index + 1) * E)

    def run(blk, ep_train):
        blk = {k: v.clone().requires_grad_() for k, v in blk.items()}
        x = h.clone().requires_grad_()
        out, aux = GPT._moe_mlp(cfg, blk, x, return_aux=True, ep=ep_train)
        ((out * weight).sum() + aux).backward()
        return out.detach(), aux.detach(), x.grad, {k: v.grad for k, v in blk.items()}

    local = {k: v[mine] if "experts" in k else v for k, v in whole.items()}
    got, want = run(local, ep), run(whole, None)
    out = {"out": got[0], "aux": got[1], "dh": got[2], **{f"d.{k}": v for k, v in got[3].items()}}
    ref = {"out": want[0], "aux": want[1], "dh": want[2],
           **{f"d.{k}": v[mine] if "experts" in k else v for k, v in want[3].items()}}
    np.savez(f"{job['out']}.{mesh.index}.npz", **{k: v.numpy() for k, v in out.items()},
             **{f"want.{k}": v.numpy() for k, v in ref.items()})


JOBS = {**TP_JOBS, "moe_mlp": job_moe_mlp}


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
