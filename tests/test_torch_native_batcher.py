"""Port parity, the native host batcher (midgpt_tpu_torch/native: the
port's copy of batcher.c, built with the system C compiler into
midgpt_tpu_torch/_build/; data/dataset.py `sample_batch`): the port's
windows against JAX's C batcher (midgpt_tpu.native.sample_windows), JAX's
sample_batch and the port's own numpy gather, bit for bit; the bounds
check with JAX's message; the build's place, its atomic publication under
concurrent builds, and a failed build said, not hidden."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from midgpt_tpu import native as j_native
from midgpt_tpu.data.dataset import sample_batch as j_sample_batch
from midgpt_tpu_torch import native
from midgpt_tpu_torch.data import dataset
from midgpt_tpu_torch.data.dataset import TokenDataset, sample_batch
from torch_threads import one_thread  # noqa: F401 (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent


def _stream(n=100_000, seed=0):
    return np.random.default_rng(seed).integers(0, 50304, n).astype(np.uint16)


def _numpy(data, starts, T):
    offsets = np.arange(T)
    return (data[starts[:, None] + offsets].astype(np.int32), data[starts[:, None] + offsets + 1].astype(np.int32))


@pytest.fixture(scope="module")
def built():
    if not native.native_available():
        pytest.fail(f"the port's batcher did not build: {native.build_error()}")
    if not j_native.native_available():
        pytest.fail("JAX's batcher did not build on a host where the port's did")


def test_the_library_builds_into_the_build_dir(built):
    """Named by the digest of the source, compiler and flags, under
    midgpt_tpu_torch/_build/ and never in the package directory."""
    path = native.library_path()
    assert path.parent == ROOT / "midgpt_tpu_torch" / "_build"
    assert path.name.startswith("libbatcher-") and path.suffix == ".so" and len(path.stem) == len("libbatcher-") + 16
    assert native.build_error() is None
    assert not [f for f in os.listdir(ROOT / "midgpt_tpu_torch" / "native") if f.endswith((".so", ".tmp"))]


@pytest.mark.parametrize("T,n,threads", [(256, 64, None), (64, 1, 1), (33, 7, 3), (128, 300, 16)],
                         ids=["many", "one_window_one_thread", "uneven_threads", "more_threads"])
def test_windows_match_jax_and_numpy(built, T, n, threads):
    data = _stream()
    starts = np.random.default_rng(1).integers(0, len(data) - T - 1, size=n)
    x, y = native.sample_windows(data, starts, T, n_threads=threads)
    jx, jy = j_native.sample_windows(data, starts, T, n_threads=threads)
    nx, ny = _numpy(data, starts, T)
    assert x.dtype == np.int32 and x.shape == (n, T)
    for got, *want in ((x, jx, nx), (y, jy, ny)):
        for w in want:
            np.testing.assert_array_equal(got, w)


def test_one_window_one_thread_is_the_stream(built):
    """JAX's test_native_single_window_and_single_thread on the port."""
    data = _stream(5000)
    x, y = native.sample_windows(data, np.asarray([17], dtype=np.int64), 64, n_threads=1)
    np.testing.assert_array_equal(x[0], data[17:81].astype(np.int32))
    np.testing.assert_array_equal(y[0], data[18:82].astype(np.int32))


@pytest.mark.parametrize("accum_slice", [None, (1, 2)], ids=["whole", "accum_slice"])
def test_sample_batch_matches_jax_on_both_paths(built, accum_slice, monkeypatch):
    """sample_batch: the native path against JAX's sample_batch (its C
    batcher) and the port's numpy path, with the paths counted."""
    data = _stream()
    draw = lambda: sample_batch(data, 128, 4, 4, rng=np.random.default_rng([7, 0, 3]),  # noqa: E731
                                accum_slice=accum_slice)
    native.PATHS.clear()
    x, y = draw()
    assert native.PATHS == {"native": 1}
    jx, jy = j_sample_batch(data, 128, 4, 4, rng=np.random.default_rng([7, 0, 3]), accum_slice=accum_slice)
    monkeypatch.setattr(native, "sample_windows", lambda *a, **k: None)
    nx, ny = draw()
    assert native.PATHS == {"native": 1, "numpy": 1}
    assert x.shape == (4 if accum_slice is None else 2, 4, 128) and x.dtype == np.int32
    for got, *want in ((x, jx, nx), (y, jy, ny)):
        for w in want:
            np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(x[..., 1:], y[..., :-1])


def test_out_of_bounds_raises_as_jax_does(built):
    data = _stream(1000)
    for starts in (np.asarray([0, 1000 - 64]), np.asarray([-1, 3])):
        with pytest.raises(IndexError) as want:
            j_native.sample_windows(data, starts, 64)
        with pytest.raises(IndexError) as got:
            native.sample_windows(data, starts, 64)
        assert str(got.value) == str(want.value)
    assert native.sample_windows(data.astype(np.int32), np.asarray([0]), 8) is None  # not uint16: numpy's


def test_concurrent_builds_publish_one_whole_library(tmp_path):
    """Four processes build into one empty build directory at once: each
    loads the same file, whole, and no temporary file is left."""
    code = ("import sys; from pathlib import Path; from midgpt_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); import numpy as np; "
            "d = np.arange(100, dtype=np.uint16); x, y = native.sample_windows(d, np.asarray([5]), 4); "
            "print(native.library_path(), x.tolist(), y.tolist())")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len(set(outs)) == 1 and outs[0].endswith("[[5, 6, 7, 8]] [[6, 7, 8, 9]]"), outs
    assert [f.name for f in tmp_path.iterdir()] == [Path(outs[0].split()[0]).name]


def test_a_failed_build_is_said_and_numpy_takes_over(tmp_path):
    """Without a compiler the library is unavailable with its reason, the
    first dataset of the process says so, and the windows are numpy's."""
    stream = _stream(4000)
    stream.tofile(tmp_path / "train.bin")
    stream.tofile(tmp_path / "val.bin")
    code = ("import sys; from midgpt_tpu_torch import native; from midgpt_tpu_torch.data.dataset import TokenDataset; "
            "ds = TokenDataset(sys.argv[1]); ds.batch('train', 0, 16, 2); TokenDataset(sys.argv[1]); "
            "print(native.native_available(), dict(native.PATHS))")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CC=str(tmp_path / "no-such-cc"))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("token windows: numpy's gather (the native batcher is unavailable: ")
    assert "no-such-cc" in lines[0] and len(lines) == 2
    assert lines[1] == "False {'numpy': 1}"


def test_the_dataset_takes_the_native_path(built, tmp_path, capsys, monkeypatch):
    """A dataset's batches come from the C batcher, JAX's windows; the
    process's first dataset says the path once."""
    from midgpt_tpu.data.dataset import TokenDataset as JTokenDataset

    stream = _stream(6000)
    stream.tofile(tmp_path / "train.bin")
    stream[:3000].tofile(tmp_path / "val.bin")
    monkeypatch.setattr(dataset, "_said", [])
    ds = TokenDataset(str(tmp_path), seed=3)
    TokenDataset(str(tmp_path), seed=3)
    assert capsys.readouterr().out == f"token windows: the native C batcher ({native.library_path()})\n"
    native.PATHS.clear()
    x, y = ds.batch("val", 5, 32, 4, 3, accum_slice=(0, 2))
    jx, jy = JTokenDataset(str(tmp_path), seed=3).batch("val", 5, 32, 4, 3, accum_slice=(0, 2))
    assert native.PATHS == {"native": 1}
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
