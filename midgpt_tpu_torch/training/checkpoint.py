"""Checkpoints of the training state with integrity manifests, saved in the
background (counterpart of midgpt_tpu/training/checkpoint.py: the same
names and semantics, in the port's own on-disk format — Orbax needs JAX).

Layout: `<rundir>/<step>/` holds one `<item>.npz` per named item of the
saved state (`params.npz` in the converter's {path: array} layout, so
`convert.load_npz` reads it; `opt_state.npz` with `mu.<leaf>`, `nu.<leaf>`
and the two counts), `format.json` (the FORMAT marker) and
`midgpt_manifest.json` (each file's size and sha256). Arrays are written by
`np.savez` without pickle; numpy has no bfloat16, so a bf16 tensor is
widened to float32 on save (exact) and cast back to its template's dtype on
restore.

  * **Async save.** `save` copies every leaf into host memory (pinned
    buffers, reused from save to save, for CUDA tensors) and synchronizes
    once: that copy is all the training loop waits for. A writer thread then
    writes the files, hashes them back from disk and commits the manifest
    (temp file + os.replace). The snapshot is complete before `save`
    returns, so the optimizer's in-place updates of the next steps cannot
    reach a checkpoint. The writer commits the manifest itself, so a save
    is a resume point as soon as its bytes are on disk; `_finalize_pending`
    joins it at the next barrier (`save`, `wait`, `restore`, `close`),
    raises whatever the writer raised, and garbage-collects.
  * **Write retry.** The write retries `write_retries` times with
    exponential backoff (robustness/backoff.py), sweeping the partial,
    un-manifested step directory before each attempt and when the budget
    runs out; then the barrier raises CheckpointWriteError. A partial step
    never shadows the last verified checkpoint.
  * **Verification.** A step is verified iff every file matches its
    manifest. `restore` re-hashes the step and raises
    CheckpointCorruptError with a per-file diagnosis; resume uses
    `latest_verified_step`, so a step cut short by a kill is skipped, never
    half-restored. A step without a manifest is never restored (the port
    has no pre-manifest checkpoints). Verification results are cached per
    step against each file's size and mtime, so the inventory calls of the
    training loop do not re-hash gigabytes.
  * **Verified-only GC.** After a save lands, steps older than the
    `max_to_keep` newest verified steps are deleted: a crash at any point
    leaves at least one verified step on disk.
  * **Faults** (robustness/faults.py), at JAX's points, in the writer
    thread: `ckpt_io_error` and `ckpt_enospc` (partial bytes first) fail a
    write attempt, which the retry absorbs; `kill_mid_save` lets the items
    land, truncates one and raises SimulatedPreemption before the manifest
    (a BaseException: no retry absorbs it, and the next barrier re-raises
    it); `truncate_ckpt_item` truncates an item after the manifest, so the
    barrier's check finds the step unverified and keeps the older ones.
  * **A mesh of ranks** (training on parallel/; the counterpart of JAX's
    process_index() == 0 writes, midgpt_tpu/training/checkpoint.py:406).
    The format does not change: `save` gathers each sharded leaf whole to
    the mesh's leader (over fsdp, then over tp, then over the pipeline's
    stages, then over the ep group), in the main thread, before the pinned host copy
    (a collective never runs in the writer thread), and only the leader
    writes, commits and garbage-collects; the others wait for its verdict
    at the next barrier and raise what it raised. The leader's reading of
    the step inventory (`latest_verified_step`, `restore`'s verification)
    is broadcast, so every rank takes the same decision; `should_save`
    reads the run directory, which every rank must see. `restore` has
    every rank read the step and keep its own slice (`select`), whatever
    rank count saved it.
"""

from __future__ import annotations

import concurrent.futures
import errno
import hashlib
import json
import os
import shutil
import threading
import time
import typing as tp
import zipfile

import numpy as np
import torch

from midgpt_tpu_torch.obs import flight_recorder
from midgpt_tpu_torch.parallel import fsdp
from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.robustness.backoff import retry_with_backoff
from midgpt_tpu_torch.robustness.errors import (
    CheckpointCorruptError,
    CheckpointWriteError,
    SimulatedPreemption,
)
from midgpt_tpu_torch.training.optim import OptState

# Format marker saved beside the state and checked at restore: JAX's
# version-3 parameter layout (wqkv (L, 3, D, D), "qkv3") in npz files.
FORMAT = {"version": 3, "qkv_layout": "qkv3", "container": "npz"}

MANIFEST_NAME = "midgpt_manifest.json"
FORMAT_NAME = "format.json"

Leaf = tp.Union[torch.Tensor, np.ndarray, int]


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _each(fn: tp.Callable, args: tp.Sequence) -> tp.List:
    """[fn(a) for a in args], one thread per argument: hashing, zip CRCs
    and file I/O release the GIL, so the files of a step overlap."""
    if len(args) < 2:
        return [fn(a) for a in args]
    with concurrent.futures.ThreadPoolExecutor(len(args)) as pool:
        return list(pool.map(fn, args))


def write_manifest(step_dir: str, step: int) -> None:
    """Commit a per-file sha256 manifest for a finished step directory.

    Written to a temp file and os.replace'd into place, so a crash mid-write
    leaves the step *unverified* (no manifest), never half-verified."""
    names = [
        n for n in sorted(os.listdir(step_dir))
        if not n.startswith(MANIFEST_NAME) and os.path.isfile(os.path.join(step_dir, n))
    ]
    paths = [os.path.join(step_dir, n) for n in names]
    files = {
        n: {"size": os.path.getsize(p), "sha256": h} for n, p, h in zip(names, paths, _each(_hash_file, paths))
    }
    manifest = {"step": step, "format": FORMAT, "files": files}
    tmp = os.path.join(step_dir, MANIFEST_NAME + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(tmp, os.path.join(step_dir, MANIFEST_NAME))


def verify_manifest(step_dir: str) -> tp.List[str]:
    """Re-checksum a step directory against its manifest. Returns a list of
    human-readable problems — empty means verified."""
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return [f"no {MANIFEST_NAME} in {step_dir} (save never completed?)"]
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        return [f"unreadable manifest {mpath}: {e}"]
    problems: tp.List[str] = []
    to_hash = []
    for rel, rec in manifest.get("files", {}).items():
        path = os.path.join(step_dir, rel)
        if not os.path.exists(path):
            problems.append(f"missing item file: {rel}")
            continue
        size = os.path.getsize(path)
        if size != rec["size"]:
            problems.append(f"truncated item file: {rel} ({size} bytes, manifest says {rec['size']})")
            continue
        to_hash.append((rel, rec["sha256"]))
    digests = _each(_hash_file, [os.path.join(step_dir, rel) for rel, _ in to_hash])
    problems += [f"checksum mismatch: {rel}" for (rel, want), got in zip(to_hash, digests) if got != want]
    return problems


def _write_npz(path: str, arrays: tp.Mapping[str, np.ndarray]) -> None:
    """What `np.savez` writes (stored .npy members, no pickle), with a fixed
    member timestamp, so the same state always gives the same bytes and
    the same manifest hashes. Each array goes out in one zero-copy write:
    zipfile's CRC and the file write release the GIL, so the writer thread
    barely holds up the training loop's Python."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, a in arrays.items():
            a = np.asarray(a, order="C")
            info = zipfile.ZipInfo(key + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as fh:
                np.lib.format.write_array_header_1_0(fh, np.lib.format.header_data_from_array_1_0(a))
                fh.write(a.reshape(-1).view(np.uint8))


def _as_numpy(leaf: Leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, as JAX hands it out
        a = a.astype(np.float32)
    return a.astype(np.int64) if a.dtype.kind in "iu" and a.ndim == 0 else a


def write_step_files(
    step_dir: str, step: int, items: tp.Mapping[str, tp.Mapping[str, Leaf]], *, commit: bool = True
) -> None:
    """Write one step directory: an npz per item, the format marker, then
    (with `commit`) the manifest — last, so the step is verified only once
    all bytes are down."""
    os.makedirs(step_dir, exist_ok=True)
    _each(
        lambda name: _write_npz(
            os.path.join(step_dir, f"{name}.npz"), {k: _as_numpy(v) for k, v in items[name].items()}
        ),
        list(items),
    )
    with open(os.path.join(step_dir, FORMAT_NAME), "w") as fh:
        json.dump(FORMAT, fh)
    if commit:
        write_manifest(step_dir, step)


def _corrupt_one_item(step_dir: str) -> None:
    """Truncate the largest non-manifest file of a step to half: realistic
    partial-write damage (the `kill_mid_save` and `truncate_ckpt_item`
    faults)."""
    sizes = [
        (os.path.getsize(os.path.join(step_dir, n)), os.path.join(step_dir, n))
        for n in os.listdir(step_dir) if not n.startswith(MANIFEST_NAME)
    ]
    if sizes:
        size, path = max(sizes)
        with open(path, "rb+") as fh:
            fh.truncate(max(1, size // 2))


def write_step_dir(rundir: str, step: int, items: tp.Mapping[str, tp.Mapping[str, Leaf]]) -> str:
    """Synchronous write of `rundir/<step>/` from flat items ({leaf name:
    array}); refuses to overwrite a step that has a manifest and clears an
    un-manifested partial one. Returns the step directory."""
    step_dir = os.path.join(os.path.abspath(rundir), str(step))
    if os.path.exists(os.path.join(step_dir, MANIFEST_NAME)):
        raise FileExistsError(f"step {step} already has a checkpoint in {step_dir}")
    shutil.rmtree(step_dir, ignore_errors=True)
    write_step_files(step_dir, step, items)
    return step_dir


def flatten_item(value: tp.Any) -> tp.Dict[str, Leaf]:
    """A saved item as {leaf name: tensor or int}: an OptState as
    `convert.opt_state_to_numpy` lays it out, a parameter dict as is."""
    if isinstance(value, OptState):
        out: tp.Dict[str, Leaf] = {f"mu.{k}": v for k, v in value.mu.items()}
        out.update({f"nu.{k}": v for k, v in value.nu.items()})
        out["adam_count"] = value.adam_count
        out["schedule_count"] = value.schedule_count
        return out
    return dict(value)


Select = tp.Callable[[str, torch.Tensor], torch.Tensor]


def _tensors_like(
    flat: tp.Mapping[str, np.ndarray], template: tp.Mapping[str, torch.Tensor], device, what: str,
    select: tp.Optional[Select] = None,
) -> tp.Dict[str, torch.Tensor]:
    extra, missing = sorted(set(flat) - set(template)), sorted(set(template) - set(flat))
    if extra or missing:
        raise ValueError(f"{what} does not fit the template: extra {extra}, missing {missing}")
    out = {}
    for name, like in template.items():
        a = flat[name]
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"{what} {name}: saved shape {a.shape}, template {tuple(like.shape)}")
        dev = torch.device(device) if device is not None else like.device
        if dev.type == "meta":
            raise ValueError(f"{what} {name}: a meta template needs restore(..., device=)")
        t = torch.from_numpy(a)  # np.load's own array
        out[name] = (select(name, t) if select is not None else t).to(device=dev, dtype=like.dtype)
    return out


def unflatten_item(
    flat: tp.Mapping[str, np.ndarray], template: tp.Any, device=None, select: tp.Optional[Select] = None
) -> tp.Any:
    """Inverse of `flatten_item`, into the template's structure, shapes and
    dtypes (and its device, unless `device` is given). `select(leaf, t)`
    cuts each whole leaf (a moment by its parameter's name) to the part
    this rank keeps."""
    if isinstance(template, OptState):
        moments = {
            m: _tensors_like(
                {k[3:]: v for k, v in flat.items() if k.startswith(m + ".")}, getattr(template, m), device,
                f"opt_state.{m}", select,
            )
            for m in ("mu", "nu")
        }
        return OptState(int(flat["adam_count"]), moments["mu"], moments["nu"], int(flat["schedule_count"]))
    return _tensors_like(flat, template, device, "params", select)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        max_to_keep: int = 2,
        save_interval_steps: int = 1000,
        write_retries: int = 3,
        retry_backoff_sec: float = 0.5,
        mesh=None,
        specs: tp.Optional[tp.Mapping[str, fsdp.Spec]] = None,
    ):
        """`mesh` and `specs` (each leaf's sharded axis, parallel/fsdp.py):
        the state is a mesh's shards (module docstring)."""
        self._dir = os.path.abspath(directory)
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._specs = dict(specs or {})
        self._leads = self._mesh is None or self._mesh.is_leader
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.write_retries = max(1, write_retries)
        self.retry_backoff_sec = retry_backoff_sec
        # The step whose writer thread is in flight, the thread, and what it
        # raised (re-raised at the next barrier).
        self._pending: tp.Optional[int] = None
        self._writer: tp.Optional[threading.Thread] = None
        self._error: tp.Optional[BaseException] = None
        self._written_key: tp.Optional[tp.Tuple] = None  # the step's stat key as its writer left it
        self._host: tp.Dict[tp.Tuple[str, str], torch.Tensor] = {}  # reused snapshot buffers
        self._verified: tp.Dict[int, tp.Tuple] = {}  # step -> stat key it verified under
        # one record per save: step, stall_s (the loop's wait), then from
        # the writer thread: bytes on disk, write_s (files + hashes +
        # manifest) and attempts
        self.history: tp.List[tp.Dict[str, tp.Any]] = []

    # -- step inventory -------------------------------------------------

    def all_steps(self) -> tp.List[int]:
        """Every numbered step directory, partial ones included."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(
            int(name) for name in os.listdir(self._dir)
            if name.isdigit() and os.path.isdir(os.path.join(self._dir, name))
        )

    def latest_step(self) -> tp.Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def _has_manifest(self, step: int) -> bool:
        return os.path.exists(os.path.join(self._step_dir(step), MANIFEST_NAME))

    def _stat_key(self, step: int) -> tp.Tuple:
        with os.scandir(self._step_dir(step)) as it:
            return tuple(sorted((e.name, e.stat().st_size, e.stat().st_mtime_ns) for e in it))

    def verify(self, step: int) -> tp.List[str]:
        """Problems with the step's integrity (a full re-hash); [] means
        verified."""
        d = self._step_dir(step)
        if not os.path.isdir(d):
            return [f"step {step} has no directory under {self._dir}"]
        return verify_manifest(d)

    def is_verified(self, step: int) -> bool:
        """`verify(step) == []`, re-hashed only when a file of the step
        changed size or mtime since it last verified."""
        if not self._has_manifest(step):
            return False
        key = self._stat_key(step)
        if self._verified.get(step) == key:
            return True
        if self.verify(step):
            return False
        self._verified[step] = key
        return True

    def verified_steps(self) -> tp.List[int]:
        return [s for s in self.all_steps() if self.is_verified(s)]

    def _newest_verified(self, n: int) -> tp.List[int]:
        """Up to n newest verified steps, newest first, hashing no step
        older than the n-th."""
        out = []
        for s in reversed(self.all_steps()):
            if len(out) == n:
                break
            if self.is_verified(s):
                out.append(s)
        return out

    def weights_version(self, step: int) -> tp.Optional[str]:
        """'<step>:<sha12>' identity of a step's committed manifest (the
        manifest records each item's sha256, so hashing the manifest file
        identifies the content without re-hashing tensor bytes). None when
        the step has no manifest."""
        path = os.path.join(self._step_dir(step), MANIFEST_NAME)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()
        return f"{step}:{digest[:12]}"

    def _agree(self, value: tp.Optional[int]) -> tp.Optional[int]:
        """The leader's value (an int >= 0 or None) on every rank."""
        if self._mesh is None:
            return value
        got = self._mesh.agree(-1 if value is None else int(value))
        return None if got < 0 else got

    def latest_verified_step(self) -> tp.Optional[int]:
        """Newest step whose manifest verifies — the only safe resume point
        (the leader's reading, on a mesh)."""
        self.wait()
        newest = self._newest_verified(1) if self._leads else []
        return self._agree(newest[0] if newest else None)

    # -- save -----------------------------------------------------------

    def should_save(self, step: int) -> bool:
        """Would a non-forced save at `step` persist? Steps at multiples of
        `save_interval_steps`, newer than every committed (manifested) or
        in-flight save."""
        committed = [s for s in self.all_steps() if self._has_manifest(s)]
        newest = max(committed + ([self._pending] if self._pending is not None else []), default=-1)
        return step % self.save_interval_steps == 0 and step > newest

    def save(self, step: int, state: tp.Mapping[str, tp.Any], *, force: bool = False) -> bool:
        """Save named items (e.g. {"params": ..., "opt_state": ...}) in the
        background; filtered by `should_save` unless `force` (the final step
        of a run). Returns whether a save was started.

        Blocks only for the previous save's barrier and the copy of every
        leaf to host memory; the files, hashes and manifest are the writer
        thread's."""
        if not force and not self.should_save(step):
            return False
        t0 = time.perf_counter()
        self._finalize_pending()
        if self._agree(int(self._leads and self.is_verified(step))):
            raise ValueError(f"step {step} already has a verified checkpoint under {self._dir}")
        if self._leads:
            # A leftover of a killed or failed attempt at this step is garbage.
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        with flight_recorder().tracer.span("ckpt.save_queue", "ckpt", "train"):
            items = self._snapshot(state)
        record = {"step": step, "stall_s": time.perf_counter() - t0}
        self.history.append(record)
        self._pending = step
        if self._leads:
            self._writer = threading.Thread(
                target=self._write, args=(step, items, record), name=f"ckpt-writer-{step}"
            )
            self._writer.start()
        return True

    def _host_buffer(self, key: tp.Tuple[str, str], t: torch.Tensor) -> torch.Tensor:
        buf = self._host.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._host[key] = buf
        return buf

    def _whole(self, key: str, leaf: torch.Tensor) -> torch.Tensor:
        """A mesh's leaf whole on its leader: a sharded leaf is gathered
        over the fsdp rows of data and sp index 0, then over the tp rows
        of fsdp index 0, then over the pp groups of tp index 0 (the layer
        axis of a pipeline's stages), then over the leader's ep group (the
        expert axis of the routed MLP's banks; the other ranks, replicas of
        these, take no part)."""
        spec = self._specs.get(key.split(".", 1)[1] if key.startswith(("mu.", "nu.")) else key)
        mesh = self._mesh
        if mesh is None or mesh.data_index != 0 or mesh.sp_index != 0:
            return leaf
        leaf = fsdp.gather(leaf.detach(), spec, mesh)
        if mesh.fsdp_index != 0:
            return leaf
        leaf = fsdp.gather_tp(leaf, spec, mesh)
        if mesh.tp_index != 0:
            return leaf
        leaf = fsdp.gather_pp(leaf, spec, mesh)
        return fsdp.gather_ep(leaf, spec, mesh) if mesh.pp_index == 0 else leaf

    def _snapshot(self, state: tp.Mapping[str, tp.Any]) -> tp.Dict[str, tp.Dict[str, Leaf]]:
        """Every leaf copied to host memory, complete on return: CUDA
        leaves as asynchronous copies into pinned buffers, then one
        synchronize per device. On a mesh, whole leaves on the leader;
        nothing is kept on the other ranks."""
        items: tp.Dict[str, tp.Dict[str, Leaf]] = {}
        devices = set()
        for name, value in state.items():
            host: tp.Dict[str, Leaf] = {}
            for key, leaf in flatten_item(value).items():
                if isinstance(leaf, torch.Tensor):
                    leaf = self._whole(key, leaf)
                    if not self._leads:
                        continue
                    buf = self._host_buffer((name, key), leaf)
                    buf.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
                    if leaf.is_cuda:
                        devices.add(leaf.device)
                    host[key] = buf
                else:
                    host[key] = int(leaf)
            items[name] = host
        for dev in devices:
            torch.cuda.synchronize(dev)
        return items

    def _write(self, step: int, items, record) -> None:
        """The writer thread: write with retries, or sweep the partial and
        leave the error for the next barrier."""
        t0 = time.perf_counter()
        attempts = 0
        d = self._step_dir(step)
        kill = faults.should_fire("kill_mid_save", step=step)

        def attempt() -> None:
            nonlocal attempts
            attempts += 1
            self._clear_partial(step)
            if faults.should_fire("ckpt_io_error"):
                raise IOError("injected transient checkpoint-write failure (faults: ckpt_io_error)")
            if faults.should_fire("ckpt_enospc"):
                # disk exhaustion mid-write: partial bytes, no manifest
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, "partial_item.bin"), "wb") as fh:
                    fh.write(b"\x00" * 1024)
                raise OSError(errno.ENOSPC, "injected ENOSPC mid checkpoint write (faults: ckpt_enospc)")
            write_step_files(d, step, items, commit=not kill)

        try:
            retry_with_backoff(
                attempt, retries=self.write_retries, base_s=self.retry_backoff_sec, retry_on=(OSError,)
            )
            if kill:
                # SIGKILL between the writes and the commit: bytes on disk,
                # one item truncated, no manifest.
                _corrupt_one_item(d)
                raise SimulatedPreemption(f"simulated kill mid-save at step {step}")
            record["bytes"] = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d))
            self._written_key = self._stat_key(step)
            if faults.should_fire("truncate_ckpt_item", step=step):
                _corrupt_one_item(d)  # later damage: the manifest no longer matches
        except SimulatedPreemption as e:  # a kill leaves its partial step behind
            self._error = e
        except OSError as e:
            self._clear_partial(step)
            err = CheckpointWriteError(
                f"checkpoint save at step {step} under {self._dir} failed {self.write_retries} "
                f"attempt(s); last error: {e}",
                step=step, attempts=self.write_retries, directory=self._dir,
            )
            err.__cause__ = e
            self._error = err
        except Exception as e:  # raised at the barrier, never swallowed
            self._clear_partial(step)
            self._error = e
        record["write_s"] = time.perf_counter() - t0
        record["attempts"] = attempts

    def _clear_partial(self, step: int) -> None:
        """Remove an un-manifested partial step directory. A directory WITH
        a manifest is a real checkpoint — verified-only GC owns it."""
        if not self._has_manifest(step):
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _finalize_pending(self) -> None:
        """Barrier on the in-flight save: join the writer, raise what it
        raised, then (only on success) garbage-collect older steps. On a
        mesh the leader's verdict reaches every rank (0: committed, 1: a
        simulated kill, 2: a failed write), and each raises on a failure."""
        step, self._pending = self._pending, None
        if step is None:
            return
        if not self._leads:
            verdict = self._mesh.agree(0)
            if verdict == 1:
                raise SimulatedPreemption(f"simulated kill mid-save at step {step} (on the leader rank)")
            if verdict:
                raise RuntimeError(f"checkpoint save at step {step} under {self._dir} failed on the leader rank")
            return
        writer, self._writer = self._writer, None
        tr = flight_recorder().tracer
        with tr.span("ckpt.finalize", "ckpt", "train"):
            writer.join()
        error, self._error = self._error, None
        written, self._written_key = self._written_key, None
        if error is None and not self._has_manifest(step):
            error = RuntimeError(f"the writer of checkpoint step {step} ended without committing its manifest")
        if self._mesh is not None:
            self._mesh.agree(0 if error is None else 1 if isinstance(error, SimulatedPreemption) else 2)
        if error is not None:
            raise error
        # The writer hashed the files back from disk into the manifest; a
        # file changed since then is re-checked.
        problems = [] if self._stat_key(step) == written else self.verify(step)
        if problems:
            tr.instant("ckpt.verify_failed", "ckpt", "train", args={"step": step, "n_problems": len(problems)})
            print(f"WARNING: checkpoint step {step} failed post-save verification and will not be resumed "
                  "from:\n  " + "\n  ".join(problems))
            return  # keep the older verified steps: no GC off an unverified save
        self._verified[step] = written
        tr.instant("ckpt.verified", "ckpt", "train", args={"step": step})
        rec = self.history[-1]
        print(f"checkpoint step {step} verified in {self._dir}: {rec['bytes'] / 1e9:.3f} GB, "
              f"loop stalled {1e3 * rec['stall_s']:.1f} ms, written and hashed in {rec['write_s']:.2f} s")
        self._gc()

    def _gc(self) -> None:
        """Delete every step older than the `max_to_keep` newest verified
        steps (runs only after a fresh save landed)."""
        newest = self._newest_verified(self.max_to_keep)
        if len(newest) < self.max_to_keep:
            return
        for s in self.all_steps():
            if s < newest[-1]:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                self._verified.pop(s, None)

    # -- restore --------------------------------------------------------

    def restore(
        self, step: int, like: tp.Mapping[str, tp.Any], *, device=None, select: tp.Optional[Select] = None
    ) -> tp.Dict[str, tp.Any]:
        """Restore named items into the structure, shapes and dtypes of
        `like` (a parameter dict or an OptState of tensors per item; tensors
        on the `meta` device are templates of shape and dtype only). Each
        tensor lands on its template's device, or on `device` when given.
        Restoring a SUBSET of the saved items is supported (the sampler
        restores only "params"). Verifies the manifest (the leader, on a
        mesh), then the format marker, then reads; `select(leaf, t)` cuts
        each whole leaf to what this rank keeps."""
        self._finalize_pending()
        available = self.all_steps()
        if step not in available:
            raise ValueError(
                f"no checkpoint for step {step} under {self._dir}; available steps: "
                f"{available or 'none'} (verified: {self.verified_steps() or 'none'})"
            )
        problems = self.verify(step) if self._leads else []
        if self._agree(int(bool(problems))) and not problems:
            problems = ["the leader rank's verification failed"]
        if problems:
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {self._dir} fails integrity verification — refusing "
                "to restore corrupt state:\n  " + "\n  ".join(problems)
                + f"\nVerified steps available: {self.verified_steps() or 'none'}",
                step=step,
                problems=problems,
            )
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, FORMAT_NAME)) as fh:
                fmt = json.load(fh)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"checkpoint step {step} has no readable 'format' marker — it is not this port's "
                f"layout (see training/checkpoint.py FORMAT). Underlying error: {e}"
            ) from e
        if fmt != FORMAT:
            raise ValueError(
                f"checkpoint format mismatch at step {step}: saved marker {fmt}, this build reads "
                f"{FORMAT} — refusing a silently-wrong restore. Available steps under {self._dir}: "
                f"{available}."
            )
        for name in like:
            if not os.path.exists(os.path.join(d, f"{name}.npz")):
                raise ValueError(f"checkpoint step {step} under {self._dir} has no item {name!r}")

        def read(name: str) -> tp.Any:
            with np.load(os.path.join(d, f"{name}.npz")) as f:
                flat = {k: f[k] for k in f.files}
            return unflatten_item(flat, like[name], device, select)

        return dict(zip(like, _each(read, list(like))))

    # -- lifecycle ------------------------------------------------------

    def wait(self) -> None:
        self._finalize_pending()

    def close(self) -> None:
        self.wait()
        self._host.clear()
