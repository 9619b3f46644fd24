"""Import hygiene of the port: midgpt_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and their entry points refuse to run
without CUDA unless the CPU is asked for explicitly."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "midgpt_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "midgpt_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_BLOCKER = """
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "midgpt_tpu"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
import midgpt_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(midgpt_tpu_torch.__path__, "midgpt_tpu_torch.")]
for m in mods:
    __import__(m)
import chip_smoke
assert not any(k.split(".")[0] in ("jax", "midgpt_tpu") for k in sys.modules)
print(" ".join(mods))
"""


def _run(args, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout
    )


def test_port_imports_with_jax_blocked():
    r = _run(["-c", _BLOCKER])
    assert r.returncode == 0, r.stderr
    mods = set(r.stdout.split())
    assert len(mods) >= 36  # every module of the port was imported, the fleet's worker modules too
    assert {f"midgpt_tpu_torch.parallel.{m}"
            for m in ("dist", "mesh", "fsdp", "data", "shard_map_fsdp", "tp", "serve_tp")} <= mods
    assert "midgpt_tpu_torch.robustness.chaos_train" in mods


_WORKER_BLOCKED = """
import importlib.abc, runpy, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "midgpt_tpu"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.argv = ["fleet_worker"] + sys.argv[1:]
runpy.run_module("midgpt_tpu_torch.sampling.fleet_worker", run_name="__main__")
"""


def test_worker_process_runs_with_jax_blocked():
    """A CPU worker spawned with jax and midgpt_tpu blocked from import
    announces its port on stdout (its only line there) and serves hello."""
    from midgpt_tpu_torch.robustness.chaos_serve import proc_worker_spec
    from midgpt_tpu_torch.sampling import fleet_proc as fp

    spec = proc_worker_spec(0, device="cpu")
    proc = fp._popen_worker(spec, [sys.executable, "-c", _WORKER_BLOCKED, "--spec-json", json.dumps(spec)])
    try:
        rep = fp.connect_replica(fp._await_port(proc))
        assert rep.pid == proc.pid and rep.page_size == 8 and rep.device == "cpu" and rep.prefix_cache
        rep.close()
        proc.kill()
        assert proc.stdout.read() == ""  # nothing after the PORT line
    finally:
        fp.kill_workers([proc])


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_sample_entry_point_needs_cuda_or_explicit_cpu(no_cuda):
    r = _run(["-m", "midgpt_tpu_torch.sample", "--config=shakespeare_char", "--num_samples=1", "--max_new_tokens=2"])
    assert r.returncode != 0 and "CUDA" in r.stderr
    r = _run(["-m", "midgpt_tpu_torch.sample", "--config=shakespeare_char", "--num_samples=2",
              "--max_new_tokens=3", "--device=cpu", "--temperature=0", "--engine=continuous"])
    assert r.returncode == 0, r.stderr
    assert "2 requests on cpu" in r.stdout


def test_chip_smoke_fails_without_cuda_and_alone(no_cuda, tmp_path):
    r = _run([str(ROOT / "chip_smoke.py")])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
