"""Run supervisor: restart on divergence with the data window skipped, and
on a hung step (the port's counterpart of
midgpt_tpu/robustness/supervisor.py).

`supervise(config)` wraps `train(config)` in a bounded restart policy:

  1. `train` raises DivergenceError when the sticky loss carrier goes
     non-finite (training/train.py). The poisoned batch lies in
     `(last_good_step, step]`: stickiness guarantees nothing before the
     newest verified checkpoint is bad.
  2. The supervisor rolls back by re-entering `train`, which resumes from
     `latest_verified_step()`. It advances `data_step_offset` so the
     replayed iterations sample data PAST the detected window (train
     threads `itr + data_step_offset` into the positional sampler and the
     dropout generators), as if the poisoned shard were cut out of the
     stream — deterministically, since the offset is plain config.
  3. A hang (StepHangError from the watchdog) restarts WITHOUT moving the
     offset: a wedged sync says nothing about the data, so the replay runs
     the same window again. Each hang is marked in the ledger
     (`hung_steps`).
  4. Rollbacks and hang restarts draw on one budget, `max_restarts`, with
     `backoff_sec * 2**(k-1)` seconds before the k-th restart. A divergence
     with no verified checkpoint, or one past the budget, fails loudly with
     a diagnosis of every skipped window.

Each attempt is a fresh `train` call: it builds its state, its optimizer
and its CheckpointManager anew (the manager's pinned snapshot buffers are
allocated again at the attempt's first save), and the failed attempt's
state is released before the next starts — nothing of it is held by the
caught exception once the handler ends.

The ledger, `rundir/supervisor_state.json` (`data_step_offset`,
`windows_skipped`, `restarts`, `hung_steps`, `mesh`, `mesh_history`,
`notes`), is written with an atomic replace, so a supervisor relaunched
after a preemption resumes with the same skips. A corrupt ledger is
quarantined to `supervisor_state.json.corrupt` with a warning and the run
proceeds on a fresh one: a damaged sidecar must never brick a resume whose
checkpoints are intact.

Geometry: the ledger records the live mesh (parallel/mesh.py): its rank
count as `n_devices` and its axes. A ledger that recorded another count
makes `on_resume_mesh="same"` refuse the resume; `"any"` resumes through
the new mesh's slices (the checkpoint holds whole leaves, and the batch
order is positional, so the trajectory continues).

On a mesh of several ranks every rank runs `supervise`. The leader reads
the ledger and hands it to the others, and only the leader writes it and
prints; every rank catches the same errors at the same step (the loss
and the checkpoint inventory are the ranks' agreed values,
training/train.py), so every rank takes the same restart decision.
"""

from __future__ import annotations

import json
import os
import time
import typing as tp

from midgpt_tpu_torch.config import ExperimentConfig
from midgpt_tpu_torch.device import DeviceLike
from midgpt_tpu_torch.obs import dump_flight_recorder, flight_recorder
from midgpt_tpu_torch.parallel.mesh import Mesh, run_mesh
from midgpt_tpu_torch.robustness import faults
from midgpt_tpu_torch.robustness.errors import DivergenceError, StepHangError

STATE_NAME = "supervisor_state.json"


def _state_path(rundir: str) -> tp.Optional[str]:
    return os.path.join(rundir, STATE_NAME) if rundir else None


def _load_state(rundir: str) -> tp.Dict[str, tp.Any]:
    path = _state_path(rundir)
    if path is None or not os.path.exists(path):
        return {}
    try:
        with open(path) as fh:
            state = json.load(fh)
        if not isinstance(state, dict):
            raise ValueError(f"expected a JSON object, got {type(state).__name__}")
        return state
    except (json.JSONDecodeError, ValueError, OSError) as e:
        quarantine = path + ".corrupt"
        try:
            os.replace(path, quarantine)
        except OSError:
            quarantine = "(could not quarantine)"
        print(
            f"WARNING: supervisor ledger {path} is corrupt ({e}); "
            f"quarantined to {quarantine} and starting a fresh ledger"
        )
        return {}


def _save_state(rundir: str, state: tp.Dict[str, tp.Any]) -> None:
    path = _state_path(rundir)
    if path is None:
        return
    os.makedirs(rundir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(state, fh, indent=1)
    os.replace(tmp, path)


def append_note(rundir: str, note: tp.Dict[str, tp.Any]) -> None:
    """Append an operator-visible event to the ledger's `notes` (e.g. the
    train loop's skipped emergency save); load, modify, atomic replace."""
    if _state_path(rundir) is None:
        return
    state = _load_state(rundir)
    state.setdefault("notes", []).append(dict(note))
    _save_state(rundir, state)


def supervise(
    config: ExperimentConfig,
    *,
    device: DeviceLike = None,
    mesh: tp.Optional[Mesh] = None,
    max_restarts: tp.Optional[int] = None,
    backoff_sec: tp.Optional[float] = None,
    sleep_fn: tp.Callable[[float], None] = time.sleep,
) -> dict:
    """Run `train(config, device=device, mesh=mesh)` under the restart
    policy (module docstring); the mesh defaults to every rank of the
    process group, or this process alone. Returns train's result with a
    `"supervisor"` summary added. `max_restarts` / `backoff_sec` default to
    the config's knobs; `sleep_fn` is injectable so tests pay no real
    backoff."""
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.training.train import train

    if mesh is None:
        mesh = run_mesh(config, resolve_device(device))
    lead = mesh.is_leader
    say = print if lead else (lambda *a, **k: None)
    ledger_dir = config.rundir if lead else ""

    if max_restarts is None:
        max_restarts = config.max_restarts
    if backoff_sec is None:
        backoff_sec = config.restart_backoff_sec
    # Once per supervised run, not per attempt: a consumed fault stays
    # consumed across restarts, like the failure it models.
    plan = config.fault_plan or os.environ.get("MIDGPT_FAULTS", "")
    if plan:
        faults.activate_plan(plan)

    persisted = mesh.broadcast_object(_load_state(config.rundir) if lead else None)
    offset = max(config.data_step_offset, int(persisted.get("data_step_offset", 0)))
    windows: tp.List[tp.List[int]] = [list(w) for w in persisted.get("windows_skipped", [])]
    restarts = int(persisted.get("restarts", 0))
    hung: tp.List[int] = [int(s) for s in persisted.get("hung_steps", [])]
    mesh_history: tp.List[tp.Dict[str, tp.Any]] = [dict(m) for m in persisted.get("mesh_history", [])]

    geometry = mesh.geometry()
    n_prev = int(persisted["mesh"]["n_devices"]) if persisted.get("mesh") else None
    n_now = geometry["n_devices"]
    if n_prev is not None and n_prev != n_now and config.on_resume_mesh == "same":
        raise RuntimeError(
            f"supervised run in {config.rundir} previously ran on {n_prev} device(s) "
            f"(mesh {persisted['mesh'].get('axes')}), but this resume sees {n_now}; "
            "on_resume_mesh='same' refuses the topology change. Set on_resume_mesh='any' "
            "to reshard-resume across meshes (the checkpoint restores through the new "
            "mesh's shardings; the positional sampler keeps the batch order)."
        )
    if not mesh_history or mesh_history[-1] != geometry:
        mesh_history.append(geometry)

    def _persist() -> None:
        # Re-load first, so notes train appended mid-attempt survive.
        if not ledger_dir:
            return
        state = _load_state(ledger_dir)
        state.update({
            "data_step_offset": offset,
            "windows_skipped": windows,
            "restarts": restarts,
            "hung_steps": hung,
            "mesh": geometry,
            "mesh_history": mesh_history,
        })
        _save_state(ledger_dir, state)

    _persist()  # record this attempt's geometry before training starts

    while True:
        cfg = config if offset == config.data_step_offset else config.replace(data_step_offset=offset)
        try:
            result = train(cfg, device=device, mesh=mesh)
            result["supervisor"] = {
                "restarts": restarts,
                "windows_skipped": windows,
                "data_step_offset": offset,
                "hung_steps": hung,
                "mesh_history": mesh_history,
                "faults_fired": faults.fired_counts(),
            }
            return result
        except StepHangError as e:
            # Nothing about the data: replay the same window from the newest
            # verified checkpoint. The watchdog already dumped the recorder.
            hung.append(int(e.step) if e.step is not None else -1)
            if restarts >= max_restarts:
                _persist()
                raise RuntimeError(
                    f"step hung {len(hung)} time(s) (steps {hung}); restart budget "
                    f"({max_restarts}) exhausted. A recurring hang at the SAME step suggests a "
                    "wedged kernel or input pipeline; across different steps, a flaky device. "
                    f"Underlying: {e}"
                ) from e
            restarts += 1
            flight_recorder().tracer.instant(
                "supervisor.hung_restart", "supervisor", "train",
                args={"step": e.step, "waited_s": e.waited_s, "restart": restarts},
            )
            _persist()
            say(
                f"supervisor: step {e.step} HUNG after {e.waited_s:.1f}s; restarting from the "
                f"last verified checkpoint (restart {restarts}/{max_restarts})"
            )
            sleep_fn(backoff_sec * (2 ** (restarts - 1)))
        except DivergenceError as e:
            # The postmortem artifact first, before any re-raise path.
            if ledger_dir:
                dump_flight_recorder(ledger_dir)
            if e.last_good_step is None:
                raise RuntimeError(
                    f"training diverged at step {e.step} with NO verified checkpoint to roll "
                    "back to (divergence before the first save). Nothing to resume; fix "
                    f"learning_rate/warmup_steps or the data and restart. Underlying: {e}"
                ) from e
            # the poisoned DATA window, in sampler (data index) coordinates
            lo = e.last_good_step + 1 + offset
            hi = e.step + offset
            if restarts >= max_restarts:
                raise RuntimeError(
                    f"training diverged {restarts + 1} time(s); restart budget ({max_restarts}) "
                    f"exhausted. Data windows skipped so far: {windows}; the final divergence "
                    f"was detected in data window [{lo}, {hi}]. Recurring divergence across "
                    "DIFFERENT data windows points at the optimization (lower learning_rate / "
                    "raise warmup_steps), not at one bad shard."
                ) from e
            windows.append([lo, hi])
            restarts += 1
            offset += max(1, e.step - e.last_good_step)
            flight_recorder().tracer.instant(
                "supervisor.rollback", "supervisor", "train",
                args={"step": e.step, "last_good_step": e.last_good_step,
                      "window": [lo, hi], "restart": restarts},
            )
            _persist()
            say(
                f"supervisor: divergence at step {e.step}; rolling back to verified step "
                f"{e.last_good_step}, skipping data window [{lo}, {hi}] "
                f"(restart {restarts}/{max_restarts})"
            )
            sleep_fn(backoff_sec * (2 ** (restarts - 1)))
