"""The rank program of tests/test_torch_tp.py: every rank that
`torchrun --standalone` starts joins one gloo group (parallel/dist.py),
runs each job of the spec in order, and writes what the test compares to
<out>.<rank>.json. Every rank runs every job: the serving meshes are
built by the whole group (creating a process group is collective), and
the ranks outside a job's mesh go on to the next job.

    OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        tests/torch_tp_ranks.py SPEC.json
"""

import contextlib
import io
import json
import sys
import time

import numpy as np
import torch

from midgpt_tpu_torch.convert import params_from_numpy
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig, PagedKVCache
from midgpt_tpu_torch.parallel import dist
from midgpt_tpu_torch.parallel.serve_tp import TPDivergenceError, make_serve_mesh
from midgpt_tpu_torch.sampling.disagg import DisaggServe
from midgpt_tpu_torch.sampling.serve import ServeEngine
from midgpt_tpu_torch.sampling.spec import self_draft

CPU = torch.device("cpu")
TIMEOUT_S = 120  # every collective of the test's meshes: a lost rank raises, never hangs


def _params(job):
    cfg = GPTConfig(**job["model"])
    return cfg, params_from_numpy(dict(np.load(job["weights"])), config=cfg, device=CPU)


def _engine(job, mesh, cfg, params, **over):
    kw = dict(job["engine"], **over)
    kw["cache_dtype"] = {"f32": torch.float32, "int8": torch.int8}[kw.pop("dtype")]
    if kw.pop("spec", False):
        dcfg, dparams = self_draft(cfg, params, 1)
        kw.update(draft_params=dparams, draft_config=dcfg, draft_shares_cache=True, spec_k_max=4)
    return ServeEngine(cfg, params, device=CPU, mesh=mesh, **kw)


def _serve(eng, trace):
    """The leader submits the trace and runs it, then stops its followers;
    a follower follows. Every rank returns its streams."""
    if eng.mesh is None or eng.mesh.is_leader:
        uids = [eng.submit(p, m) for p, m in trace]
        done = eng.run()
        eng.stop_followers()
    else:
        uids = list(range(len(trace)))
        done = eng.follow()
    return [done[u].tokens.tolist() for u in uids]


def _prefill_logits(eng, cfg, params, prompt):
    """The first chunk's logits of `prompt` through this rank's shard (a
    fresh pool of the engine's shard) and through the whole weights."""
    cache = PagedKVCache.init(cfg, 4, 8, torch.float32, device=CPU, tp_size=eng.tp_size)
    whole = PagedKVCache.init(cfg, 4, 8, torch.float32, device=CPU)
    table = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    tok = torch.tensor([prompt[:16]])
    got, _ = GPT.prefill_paged_chunk(cfg, eng.params, tok, 0, tok.shape[1], cache, table, tp_shard=eng._tp)
    want, _ = GPT.prefill_paged_chunk(cfg, params, tok, 0, tok.shape[1], whole, table)
    return float((got - want).abs().max() / want.abs().max())


def job_serve(job, out):
    """Each case on a tp mesh over ranks [0, tp): the streams of every
    member, and the leader's stats and logit error."""
    mesh = make_serve_mesh(job["tp"], device=CPU, timeout_s=TIMEOUT_S)
    for case in job["cases"]:
        cfg, params = _params(case)
        if not mesh.member:
            continue
        eng = _engine(case, mesh, cfg, params)
        rec = {"streams": _serve(eng, case["trace"])}
        rec["logit_err"] = _prefill_logits(eng, cfg, params, case["trace"][0][0])  # collective: every member
        if mesh.is_leader:
            st = eng.stats()
            rec.update(mesh=st["mesh"], per_shard=st["cache_hbm_bytes_per_shard"], total=st["cache_hbm_bytes"],
                       pool=list(eng.cache.k.shape), spec=eng.spec_stats() if case["engine"].get("spec") else None)
        out[case["name"]] = rec


def job_sampled(job, out):
    """temperature > 0: every member's streams (one seed, whole logits)."""
    mesh = make_serve_mesh(job["tp"], device=CPU, timeout_s=TIMEOUT_S)
    cfg, params = _params(job)
    if mesh.member:
        eng = _engine(job, mesh, cfg, params, temperature=0.8, top_k=20)
        out["sampled"] = {"streams": _serve(eng, job["trace"])}


def job_diverge(job, out):
    """Rank 1's allocator hands its pages out in another order: every
    member must raise TPDivergenceError in the same round, promptly."""
    mesh = make_serve_mesh(job["tp"], device=CPU, timeout_s=TIMEOUT_S)
    cfg, params = _params(job)
    if not mesh.member:
        return
    eng = _engine(job, mesh, cfg, params)
    if dist.rank() == 1:
        eng.allocator._free.reverse()
    t0 = time.perf_counter()
    try:
        _serve(eng, job["trace"])
        out["diverge"] = {"raised": None}
    except TPDivergenceError as e:
        out["diverge"] = {"raised": str(e), "round": eng.rounds, "seconds": time.perf_counter() - t0}


def job_resize(job, out):
    """A live resize mid-trace on the leader (journaled to its follower):
    the streams, and each rank's pool after it."""
    mesh = make_serve_mesh(job["tp"], device=CPU, timeout_s=TIMEOUT_S)
    cfg, params = _params(job)
    if not mesh.member:
        return
    eng = _engine(job, mesh, cfg, params)
    if mesh.is_leader:
        uids = [eng.submit(p, m) for p, m in job["trace"]]
        for _ in range(job["resize_after"]):
            eng.step()
        eng.resize(job["num_pages"])
        done = eng.run()
        eng.stop_followers()
        streams = [done[u].tokens.tolist() for u in uids]
    else:
        done = eng.follow()
        streams = [done[u].tokens.tolist() for u in sorted(done)]
    out["resize"] = {"streams": streams, "pool": list(eng.cache.k.shape), "resizes": eng.resizes}


def job_disagg(job, out):
    """DisaggServe on a (data 2, tp 2) mesh: the leader's streams and stats."""
    mesh = make_serve_mesh(job["tp"], data=2, device=CPU, timeout_s=TIMEOUT_S)
    cfg, params = _params(job)
    kw = dict(job["engine"])
    kw["cache_dtype"] = {"f32": torch.float32, "int8": torch.int8}[kw.pop("dtype")]
    dis = DisaggServe(cfg, params, mesh=mesh, device=CPU, **kw)
    if mesh.is_leader:
        uids = [dis.submit(p, m) for p, m in job["trace"]]
        done = dis.run()
        dis.stop_followers()
        st = dis.stats()
        out["disagg"] = {"streams": [done[u].tokens.tolist() for u in uids], "queue": st["queue"],
                         "fallback": st["fallback_reprefills"],
                         "meshes": [st["prefill"]["mesh"], st["decode"]["mesh"]]}
    else:
        dis.follow()
        out["disagg"] = {"finished": len(dis.finished)}


def job_loadgen(job, out):
    """`loadgen.main` with --tp on every rank of the group; the leader's
    printed line."""
    from midgpt_tpu_torch import loadgen

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = loadgen.main(job["argv"])
    out["loadgen"] = {"rc": rc, "stdout": buf.getvalue()}


JOBS = {"serve": job_serve, "sampled": job_sampled, "diverge": job_diverge, "resize": job_resize,
        "disagg": job_disagg, "loadgen": job_loadgen}


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as fh:
        spec = json.load(fh)
    dist.init("cpu")
    out = {}
    try:
        for job in spec["jobs"]:
            JOBS[job["kind"]](job, out)
        torch.distributed.barrier()
    finally:
        with open(f"{spec['out']}.{dist.rank()}.json", "w") as fh:
            json.dump(out, fh)
        dist.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
