"""Token-stream dataset: uint16 bins + seeded random-window sampling
(counterpart of midgpt_tpu/data/dataset.py).

`train.bin` / `val.bin` are flat uint16 token streams (nanoGPT's format),
with an optional `meta.pkl`. Every batch is drawn from
`np.random.default_rng([seed, split, step])` — stateless, deterministic and
exactly replayable — so the port draws the same windows as the JAX package
for the same (seed, split, step). Windows of a uint16 stream are gathered
by the native C batcher (midgpt_tpu_torch/native, built at first use), as
JAX's are; numpy's gather is its plain version, bit for bit the same, and
takes over only where the library is unavailable: the first dataset of a
process says which path it takes, and why. `shard_by_process` cuts each
stream by node, as JAX cuts it by process.
"""

from __future__ import annotations

import os
import pickle
import typing as tp

import numpy as np

from midgpt_tpu_torch import native

_SPLIT_IDS = {"train": 0, "val": 1}
_said: tp.List[str] = []  # the path line, once a process


def sample_batch(
    data: np.ndarray,
    block_size: int,
    batch_size: int,
    g_accum_iters: tp.Optional[int] = None,
    *,
    rng: tp.Optional[np.random.Generator] = None,
    accum_slice: tp.Optional[tp.Tuple[int, int]] = None,
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Random (x, y = x shifted by one) windows, int32, of shape (B, T), or
    (G, B, T) when g_accum_iters is given.

    accum_slice=(lo, m) materializes only accumulation steps [lo, lo + m) of
    the full (g_accum_iters, B, T) draw: all window starts are drawn, then
    sliced, so chunked consumers see the windows a monolithic caller sees.

    The gather is the native batcher's where it loaded and the stream is
    uint16, else numpy's (the RNG is numpy's either way: the two are bit
    for bit the same); `native.PATHS` counts each call's path."""
    rng = rng or np.random.default_rng()
    bs = batch_size * (g_accum_iters or 1)
    starts = rng.integers(0, len(data) - block_size, size=(bs,))
    if accum_slice is not None:
        if g_accum_iters is None:
            raise ValueError("accum_slice needs g_accum_iters")
        lo, m = accum_slice
        starts = starts[lo * batch_size : (lo + m) * batch_size]
        g_accum_iters = m
    xy = native.sample_windows(data, starts, block_size)
    if xy is not None:
        x, y = xy
        native.PATHS["native"] += 1
    else:
        offsets = np.arange(block_size)
        x = data[starts[:, None] + offsets].astype(np.int32)
        y = data[starts[:, None] + offsets + 1].astype(np.int32)
        native.PATHS["numpy"] += 1
    if g_accum_iters is not None:
        x = x.reshape(g_accum_iters, batch_size, block_size)
        y = y.reshape(g_accum_iters, batch_size, block_size)
    return x, y


class TokenDataset:
    """train/val uint16 streams from `data_dir`, read into host RAM."""

    def __init__(
        self,
        data_dir: str,
        *,
        seed: int = 1337,
        shard_by_process: bool = False,
    ):
        """shard_by_process: give this node (JAX's process,
        parallel/dist.py) a contiguous 1/n_nodes slice of EACH split, JAX's
        rule (midgpt_tpu/data/dataset.py:103-110)."""
        self.data_dir = data_dir
        self.seed = seed
        self.splits: tp.Dict[str, np.ndarray] = {}
        # Prep pipelines that retrain their tokenizer (data/local_text)
        # fingerprint the bins in meta.pkl; bins from an older prepare run
        # would otherwise train silently on re-interpreted ids.
        expected = (self.meta() or {}).get("split_tokens", {})
        for split in ("train", "val"):
            path = os.path.join(data_dir, f"{split}.bin")
            arr = np.fromfile(path, dtype=np.uint16)
            if expected.get(split, len(arr)) != len(arr):
                raise ValueError(
                    f"{path} has {len(arr):,} tokens but meta.pkl records "
                    f"{expected[split]:,} — the bins predate the committed "
                    "tokenizer/meta. Re-run the dataset's prepare.py."
                )
            if shard_by_process:
                from midgpt_tpu_torch.parallel import dist

                # Equal-length contiguous slices (remainder tokens dropped) so
                # every node samples from the same-sized pool.
                per = len(arr) // dist.n_nodes()
                arr = arr[dist.node() * per:(dist.node() + 1) * per].copy()
            self.splits[split] = arr
        if not _said:
            _said.append(f"token windows: the native C batcher ({native.library_path()})" if native.native_available()
                         else f"token windows: numpy's gather (the native batcher is unavailable: "
                              f"{native.build_error()})")
            print(_said[0])

    def __getitem__(self, split: str) -> np.ndarray:
        return self.splits[split]

    def batch(
        self,
        split: str,
        step: int,
        block_size: int,
        batch_size: int,
        g_accum_iters: tp.Optional[int] = None,
        accum_slice: tp.Optional[tp.Tuple[int, int]] = None,
    ) -> tp.Tuple[np.ndarray, np.ndarray]:
        """Deterministic batch for (split, step): resumable by construction."""
        rng = np.random.default_rng([self.seed, _SPLIT_IDS[split], step])
        return sample_batch(
            self.splits[split], block_size, batch_size, g_accum_iters, rng=rng,
            accum_slice=accum_slice,
        )

    def meta(self) -> tp.Optional[dict]:
        """The dataset's metadata (char codec, split sizes) if present."""
        path = os.path.join(self.data_dir, "meta.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)  # the dataset's own prepare output
