"""Port parity, the load harness: midgpt_tpu_torch/loadgen.py against
tools/loadgen.py (imported by path). For two seeds, the prompt/length
mixture (plain and template-headed) and the arrival times (Poisson and
bursty) equal JAX's exactly, and so do the percentile and point
summaries. A tiny `--device cpu` run prints one JSON line that JAX's
`check_serve_slo_bench` passes with no problems, with no capture inside a
timed point, the prefix cache hitting and a hot swap on every point.
JAX's tensor-parallel and virtual-device options are refused with the
ROADMAP item that brings them; `--fleet` is checked as JAX checks it
(`--procs` in tests/test_torch_fleet_proc.py).
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from midgpt_tpu.analysis.bench_contract import check_serve_slo_bench
from midgpt_tpu_torch import loadgen
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_loadgen", ROOT / "tools" / "loadgen.py")
jax_loadgen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_loadgen)


@pytest.mark.parametrize("seed", [0, 1])
def test_request_stream_equals_jax(seed):
    for process in ("poisson", "bursty"):
        got = loadgen._arrivals(process, 7.5, 24, np.random.default_rng(seed), 4)
        assert got == jax_loadgen._arrivals(process, 7.5, 24, np.random.default_rng(seed), 4)
    t_rng = np.random.default_rng(seed + 31)
    templates = [t_rng.integers(0, 50304, 24, np.int64) for _ in range(2)]
    for block, long_frac, kw in ((64, 0.25, {}), (1024, 0.25, dict(templates=templates, template_frac=0.5)),
                                 (4096, 0.5, {})):
        got = loadgen._mixture(np.random.default_rng(seed + 1000), 24, block, 50304, long_frac, **kw)
        want = jax_loadgen._mixture(np.random.default_rng(seed + 1000), 24, block, 50304, long_frac, **kw)
        assert len(got) == len(want) == 24
        for (gp, gm), (wp, wm) in zip(got, want):
            np.testing.assert_array_equal(gp, wp)
            assert gm == wm
    rng = np.random.default_rng(seed)
    records = [{"status": s, "ttft_s": t, "tpot_s": t / 7 if t else None}
               for s, t in zip(rng.choice(["ok", "shed", "timeout"], 20, p=[0.7, 0.2, 0.1]), rng.random(20))]
    for r in records:
        if r["status"] == "shed":
            r["ttft_s"] = r["tpot_s"] = None
    for args in ((5.0, records, 0.2, 0.0, 0.0), (5.0, records, 0.5, 800.0, 90.0), (5.0, [], 0.2, 0.0, 0.0)):
        assert loadgen._point_stats(*args) == jax_loadgen._point_stats(*args)


def test_cpu_run_passes_the_serve_slo_contract(capsys):
    """Template traffic with the prefix cache, overlap "double" and a hot
    swap on each of two points: the contract holds, nothing was captured
    (the CPU runs eagerly), every request completed, both points flipped."""
    argv = ["--device", "cpu", "--rates", "20,60", "--prefix-cache", "--template-frac", "0.5",
            "--overlap", "double", "--hot-swap"]
    assert loadgen.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert check_serve_slo_bench(rec) == []
    assert rec["backend"] == rec["device"] == "cpu" and rec["cache_dtype"] == "float32"
    assert rec["weights_versions"][0] == "inline" and rec["weights_version"] == rec["weights_versions"][1]
    assert rec["hot_swaps"] == 2 and rec["prefix_hit_rate"] > 0
    for p in rec["points"]:
        assert p["captures"] == 0 and p["completed"] == p["n_offered"] == 8 and p["hot_swaps"] == 1
        assert p["swap_flip_round"] >= 1 and p["prefill_tokens_saved"] >= 0


@pytest.mark.parametrize("flag,item", [(["--tp", "2", "--fleet", "2"], "--fleet is incompatible with --hot-swap and --tp"),
                                       (["--cpu-devices", "8"], "--tp N --device cpu")])
def test_jax_only_options_are_refused(capsys, flag, item):
    """JAX's refusal of --fleet with --tp, and --cpu-devices, whose message
    names the port's ranks under torchrun in its place."""
    with pytest.raises(SystemExit) as ei:
        loadgen.main(["--device", "cpu"] + flag)
    assert ei.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("flag,world,why", [(["--tp", "1"], 1, "needs 2 <= tp <= 1 ranks"),
                                            (["--tp", "2"], 1, "needs 2 <= tp <= 1 ranks"),
                                            (["--tp", "2", "--n-head", "3", "--n-embd", "48"], 2, "must divide n_head 3")])
def test_tp_needs_enough_ranks(monkeypatch, flag, world, why):
    """JAX's --tp checks (2 <= tp <= the ranks torchrun started, tp
    divides n_head), before any process group is joined."""
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit, match=why):
        loadgen.main(["--device", "cpu"] + flag)


@pytest.mark.parametrize("flag,why", [(["--fleet", "1"], ">= 2 replicas"), (["--fleet", "2", "--hot-swap"], "hot-swap")])
def test_fleet_option_is_accepted_and_checked(capsys, flag, why):
    """--fleet N is JAX's option (tests/test_torch_fleet.py runs it); one
    replica cannot fail over and a fleet point stages no hot swap."""
    with pytest.raises(SystemExit) as ei:
        loadgen.main(["--device", "cpu"] + flag)
    assert ei.value.code == 2 and why in capsys.readouterr().err


def test_runs_on_cuda_unless_told_otherwise():
    """`python -m midgpt_tpu_torch.loadgen` without `--device cpu` needs
    CUDA: on a machine without it, it fails naming CUDA."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "midgpt_tpu_torch.loadgen", "--rates", "20,60"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "CUDA" in r.stderr and '"bench"' not in r.stdout
