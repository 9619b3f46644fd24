"""The rank program of tests/test_torch_tp_train.py: every rank that
`torchrun --standalone` starts joins one gloo group (parallel/dist.py),
runs each job of the spec in order, and the leader of each job's mesh
writes what the test compares. Every rank runs every job: a mesh of
several ranks is built by the whole group (creating a process group is
collective), and the ranks outside it go on to the next job. The jobs of
tests/torch_parallel_ranks.py (its checkpoints, elastic resume and the
launcher) run here on tp meshes too.

    OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_tp_train_ranks.py SPEC.json
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_parallel_ranks import JOBS as PARALLEL_JOBS  # noqa: E402
from torch_parallel_ranks import nodes  # noqa: E402

from midgpt_tpu_torch.config import MeshConfig, from_json  # noqa: E402
from midgpt_tpu_torch.convert import params_from_numpy  # noqa: E402
from midgpt_tpu_torch.models.gpt import GPT  # noqa: E402
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy  # noqa: E402
from midgpt_tpu_torch.parallel import dist, fsdp  # noqa: E402
from midgpt_tpu_torch.parallel.data import rank_rows  # noqa: E402
from midgpt_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from midgpt_tpu_torch.parallel.tp import TPTrain  # noqa: E402
from midgpt_tpu_torch.training.optim import global_norm, make_optimizer  # noqa: E402
from midgpt_tpu_torch.training.train import make_train_step, state_specs, train  # noqa: E402

CPU = torch.device("cpu")


def _mesh(job, key="mesh", ranks="ranks"):
    return make_mesh(MeshConfig(**job[key]), ranks=job[ranks], device=CPU)


def _alone():
    """A mesh of this rank alone: the single-device trainer."""
    return make_mesh(MeshConfig(data=1, fsdp=1), ranks=[dist.rank()], device=CPU)


def _steps(config, mesh, whole, batches, capture=None, generators=None):
    """Train steps from whole weights on this rank's rows; returns the
    losses and the whole params and moments (collective over the mesh).
    `capture` collects each step's reduced gradients (whole) and norm."""
    specs = state_specs(config, mesh)
    params = fsdp.shard_tree({k: v.clone() for k, v in whole.items()}, specs, mesh)
    opt, _ = make_optimizer(config)
    if capture is not None:
        update = opt.update

        def spy(grads, state, p, norm=None):
            capture.append({"norm": float(global_norm(grads) if norm is None else norm),
                            **{f"g.{k}": v.numpy().copy() for k, v in fsdp.whole_tree(grads, specs, mesh).items()}})
            return update(grads, state, p, norm=norm)

        opt.update = spy
    state = opt.init(params)
    step, _ = make_train_step(config, opt, mesh, specs)
    losses = []
    for i, (x, y) in enumerate(zip(batches["x"], batches["y"])):
        x, y = (torch.from_numpy(rank_rows(a, mesh)).long() for a in (x, y))
        gens = None if generators is None else generators(i)
        params, state, loss = step(params, state, x, y, gens)
        losses.append(loss.item())
    out = {"loss": np.asarray(losses)}
    for tag, tree in (("p", params), ("mu", state.mu), ("nu", state.nu)):
        out.update({f"{tag}.{k}": v.numpy() for k, v in fsdp.whole_tree(tree, specs, mesh).items()})
    return out


def _load(job, config):
    return params_from_numpy(dict(np.load(job["weights"])), config=config.model_config, device=CPU)


def job_step(job):
    """Steps on the job's mesh; the leader also runs them alone (the
    single-device reference) and saves both."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if not mesh.member:
        return
    whole, batches = _load(job, config), np.load(job["batches"])
    out = _steps(config, mesh, whole, batches)
    if mesh.is_leader:
        ref = _steps(config, _alone(), whole, batches)
        np.savez(job["out"], **out, **{f"ref.{k}": v for k, v in ref.items()})


def job_grads(job):
    """Each step's reduced gradients and global norm, whole, on the job's
    mesh and alone: the reductions a leaf needs (test docstring)."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if not mesh.member:
        return
    whole, batches = _load(job, config), np.load(job["batches"])
    got, want = [], []
    _steps(config, mesh, whole, batches, capture=got)
    if mesh.is_leader:
        _steps(config, _alone(), whole, batches, capture=want)
        out = {}
        for i, (g, w) in enumerate(zip(got, want)):
            out.update({f"{i}.{k}": np.asarray(v) for k, v in g.items()})
            out.update({f"{i}.ref.{k}": np.asarray(v) for k, v in w.items()})
        np.savez(job["out"], **out)


def job_collectives(job):
    """Megatron's f and g around a column- then row-parallel product, and
    the vocab-parallel CE, on the tp row of ranks 0-1 against the dense
    computation on the same inputs."""
    mesh = _mesh(job)
    if not mesh.member:
        return
    tp_ = TPTrain(mesh, {"wte": (None, None), "lm_head": (None, None)})
    r = np.random.default_rng(5)
    N, D, H = 12, 16, 32
    x, w1, w2 = (torch.from_numpy(r.standard_normal(s).astype(np.float32)) for s in ((N, D), (H, D), (D, H)))
    out = {}

    def pair(x, w1, w2, sharded):
        x, w1, w2 = (t.clone().requires_grad_() for t in (x, w1, w2))
        h = tp_.copy(x) if sharded else x
        y = torch.nn.functional.gelu(h @ w1.T) @ w2.T
        y = tp_.reduce("blocks.mlp.w_down", y) if sharded else y
        (y * torch.arange(D, dtype=torch.float32)).sum().backward()
        return y.detach(), x.grad, w1.grad, w2.grad

    cols = slice(mesh.tp_index * H // 2, (mesh.tp_index + 1) * H // 2)
    got = pair(x, w1[cols], w2[:, cols], True)
    want = pair(x, w1, w2, False)
    for tag, g, w in zip(("y", "dx", "dw1", "dw2"), got, (want[0], want[1], want[2][cols], want[3][:, cols])):
        out[f"fg.{tag}.{mesh.tp_index}"], out[f"fg.{tag}.want.{mesh.tp_index}"] = g.numpy(), w.numpy()
    # the CE at 8 tokens a chunk: 3 chunks (logits kept) and 12 (recomputed)
    V = 64
    for B, T in ((2, 12), (8, 12)):
        h = torch.from_numpy(r.standard_normal((B, T, D)).astype(np.float32))
        head = torch.from_numpy(r.standard_normal((V, D)).astype(np.float32))
        y = torch.from_numpy(r.integers(0, V, (B, T)))
        rows = slice(mesh.tp_index * V // 2, (mesh.tp_index + 1) * V // 2)
        results = []
        for vocab_parallel in (True, False):
            hh = h.clone().requires_grad_()
            ww = (head[rows] if vocab_parallel else head).clone().requires_grad_()
            row = (mesh.tp_group, mesh.tp_index) if vocab_parallel else (None, 0)
            loss = fused_linear_cross_entropy(hh, ww, y, 8, None, *row)
            (loss * 3.0).backward()
            results.append((loss.detach(), hh.grad, ww.grad if vocab_parallel else ww.grad[rows]))
        for tag, g, w in zip(("loss", "dh", "dw"), *results):
            out[f"ce{B}.{tag}.{mesh.tp_index}"], out[f"ce{B}.{tag}.want.{mesh.tp_index}"] = g.numpy(), w.numpy()
    np.savez(f"{job['out']}.{mesh.tp_index}.npz", **out)


def job_dropout(job):
    """`train` with dropout on every site (embedding, attention
    probabilities, both residual branches): each rank of the row records
    the residual stream after every block, and the leader also trains
    alone (the same generators: its batch position is 0 too) and saves
    both runs' final eval losses and whole params."""
    config, mesh = from_json(job["config"]), _mesh(job)
    if not mesh.member:
        return
    streams = []
    block = GPT._block_apply

    def recording(*a, **k):
        out = block(*a, **k)
        streams.append(out.detach().numpy().copy())
        return out

    GPT._block_apply = recording
    try:
        got = train(config, device=CPU, mesh=mesh)
        np.savez(f"{job['out']}.{mesh.tp_index}.npz", *streams)
        specs = state_specs(config, mesh)
        whole = {f"p.{k}": v.numpy() for k, v in fsdp.whole_tree(got["params"], specs, mesh).items()}
        if mesh.is_leader:
            ref = train(config, device=CPU, mesh=_alone())
            np.savez(f"{job['out']}.runs.npz", loss=got["metrics"]["loss/final"], **whole,
                     **{"ref.loss": ref["metrics"]["loss/final"]},
                     **{f"ref.p.{k}": v.numpy() for k, v in ref["params"].items()})
    finally:
        GPT._block_apply = block


def job_remat(job):
    """The step under each remat policy on the job's mesh (remat off
    first); the leader saves every run."""
    mesh = _mesh(job)
    if not mesh.member:
        return
    runs = {}
    for tag, cfg_json in job["configs"].items():
        config = from_json(cfg_json)
        runs.update({f"{tag}.{k}": v for k, v in
                     _steps(config, mesh, _load(job, config), np.load(job["batches"])).items()})
    if mesh.is_leader:
        np.savez(job["out"], **runs)


JOBS = {**PARALLEL_JOBS, "step": job_step, "grads": job_grads, "collectives": job_collectives,
        "dropout": job_dropout, "remat": job_remat}


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
