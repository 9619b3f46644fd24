"""Training runtime: the train step and the host-side experiment loop
(counterpart of midgpt_tpu/training/train.py), on one device or on a mesh
of ranks (parallel/).

Step semantics follow the JAX step (reference train.py:69-97):
  * f32 master parameters, cast to the compute dtype (bf16) once per step;
    gradients are taken with respect to that cast copy;
  * G = g_accum_iters microbatches: each microgradient is cast to f32,
    scaled by 1/G and added to an f32 accumulator (G == 1: cast only);
    the reported loss is the mean of the microlosses;
  * the optimizer chain (training/optim.py) updates the master parameters
    in place, and the loss is folded with the sticky `health_flag`.
PyTorch runs eagerly: the step is a Python function, not one compiled
program. Eval runs `eval_steps` seeded batches at the compute dtype with
dropout off. With `model_config.remat` each block of the training forward
is checkpointed under `remat_policy` (models/gpt.py `GPT.hidden`). Under
`debug`, the first step after the first is traced with torch.profiler
(training/metrics.py `Profiler`), as JAX traces it.

`train` checkpoints and resumes as JAX's does (midgpt_tpu/training/train.py:497-849):
a run with a `rundir` (and not `debug`) resumes from the newest verified
step (training/checkpoint.py), checks the restored state is finite, saves
in the background every `eval_interval` steps after one host check of the
sticky loss, and force-saves the final step. Data and dropout are
positional (`data_step_offset`, `_generators`), so a resumed run continues
the straight run's trajectory.

On a mesh (parallel/mesh.py; the data, fsdp, sp, tp, pp and ep axes, one
rank per device) every rank runs this loop, as every JAX process runs its
own:

  * the master weights and Adam moments are this rank's shards
    (`state_specs`: JAX's tp_param_specs rule, parallel/tp.py, which at tp
    1 and ep 1 is the FSDP rule; under pp its pipeline rule), drawn sharded at birth
    from the seed (`init_state`) or cut from the whole leaves of a
    checkpoint;
  * the step gathers the compute-dtype copy over fsdp; the tp shards stay
    on their rank. Under fsdp_mode="gspmd" it gathers every leaf once per
    step; under "shard_map" the ZeRO-3 schedule gathers per layer
    (parallel/shard_map_fsdp.py). Under tp the forward places Megatron's
    collectives over the tp row (models/gpt.py `hidden(tp_train=)`, the
    vocab-parallel CE of ops/loss.py under tp_vocab), and every rank of a
    row computes the same loss;
  * each rank takes the rows of its batch position and the columns of its
    sequence shard (parallel/data.py: a tp row shares its block) and
    backpropagates its mean loss over the data x fsdp x sp token shards;
    under sp the forward runs on the rank's Tl = T/sp tokens at positions
    sp_index*Tl + arange(Tl) of a T-row RoPE table, with the config's
    sequence-parallel attention bound to the sp group (`sequence_parallel`:
    the ring of parallel/ring_attention.py or parallel/ulysses.py, on the
    rank's own heads under tp, as JAX binds them at train.py:106-131); in
    every microstep the gather's backward
    reduce-scatters the gradients over the fsdp row and
    `fsdp.reduce_grads` sums each over the ranks that saw other rows or
    other sequence shards (and the QK-norm scales over the tp row, whose
    ranks each hold their heads' share), so each rank holds its shard of
    the global batch's gradient,
    as JAX constrains it (train.py:217,234). The global norm counts each
    part of a leaf once (training/optim.py `global_norm`); the optimizer
    updates the shards;
  * under ep the routed MLP's banks are the rank's E/ep experts, and the
    forward places the ep group's f and g around them (parallel/tp.py
    EPTrain, models/gpt.py `hidden(ep_train=)`): every rank of an ep group
    holds the same stream, loss and aux term, the aux term's means are
    summed over the batch positions of one ep index (`aux_reduce`), and no
    gradient is summed over ep (`fsdp.reduce_grads`); the global norm
    counts each bank's shards once (training/optim.py);
  * the reported loss and the health flag are reduced over the ranks in
    one all-reduce that counts each tp row and each ep group once, so
    every rank reports the same loss and takes the same rollback decision;
    eval sums each batch position's rows the same way;
  * the checkpoint is JAX's format, whole leaves gathered to the leader
    (training/checkpoint.py); only the leader writes metrics, traces,
    the flight recorder and the supervisor's ledger;
  * dropout draws from generators seeded by batch position as well as by
    step and microstep, so the batch positions' masks differ (parity with
    JAX in distribution only) and the ranks of a tp row draw the same ones:
    they hold the residual stream whole, and the attention-probability
    masks over their heads are their part of the whole heads' mask
    (ops/dropout.py `shard`).
  * under pp (parallel/pipeline.py) a stage holds its L/pp layers, and the
    step's value and gradient are the schedule's (GPipe or 1F1B, JAX's
    make_pipeline_loss / make_pipeline_loss_and_grad); eval runs GPipe's
    forward under both. The stages of a batch position read its rows, a
    rank's loss is its stage's share (its CE rows' mean over pp), the
    block gradients are summed inside their stage and wte's and lm_head's
    over the stages too (`fsdp.reduce_grads`); the global norm counts
    each stage's layers (training/optim.py).
A mesh of one rank issues no collective: the trainer is then the
single-device one, bit for bit.

The robustness hooks sit where JAX puts them (train.py:581-816), and
`robustness/supervisor.py` runs `train` under its restart policy:

  * the loop records `train.eval`, `train.step` and `train.sync` spans and
    lifecycle instants into the process-global flight recorder (obs/).
    CUDA launches are asynchronous, so the step span covers the host's
    enqueue of the step, not its device time, which lands in the next
    `train.sync`;
  * both loss syncs (the log interval's and the check before a save) go
    through `_sync`, which the hung-step watchdog bounds when
    `watchdog_deadline_s > 0` (robustness/watchdog.py);
  * the `nan_grad`, `preempt`, `resume_reshard` and `hang_step` faults
    (robustness/faults.py) strike at their data step. `nan_grad` poisons
    the health carrier that goes INTO the step, so on a mesh the step's
    reduction carries it to every rank (JAX poisons the carrier the step
    returns: the reported loss is NaN at the same step either way);
    `resume_reshard` ends the run like a preemption, and
    robustness/chaos_train.py resumes it on another rank count;
  * a divergence records a `train.divergence` instant, then raises
    DivergenceError naming the newest verified step;
  * every `preempt_check_interval` steps a requested preemption (SIGTERM,
    SIGINT, the `preempt` fault) makes one emergency save at this step
    boundary — unless the `preempt_grace_s` budget is already spent, when
    the save is skipped loudly — then the loop ends: no final eval, no
    final save, `metrics["preempted"] = True`. On a mesh the request is
    any rank's (robustness/preempt.py), and so is a spent budget.
"""

from __future__ import annotations

import functools
import math
import threading
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.config import ExperimentConfig
from midgpt_tpu_torch.data.dataset import TokenDataset
from midgpt_tpu_torch.device import DeviceLike, resolve_device
from midgpt_tpu_torch.models.gpt import GPT, Params, param_shapes
from midgpt_tpu_torch.obs import dump_flight_recorder, flight_recorder
from midgpt_tpu_torch.ops.loss import fused_linear_cross_entropy
from midgpt_tpu_torch.parallel import dist as pdist
from midgpt_tpu_torch.parallel import fsdp
from midgpt_tpu_torch.parallel.data import node_batch_size, rank_rows
from midgpt_tpu_torch.parallel.mesh import Mesh, run_mesh
from midgpt_tpu_torch.parallel.pipeline import Pipeline, pipeline_param_specs
from midgpt_tpu_torch.parallel.tp import HEAD_REGION_LEAVES, EPTrain, TPTrain, tp_param_specs
from midgpt_tpu_torch.robustness import faults, preempt
from midgpt_tpu_torch.robustness.errors import DivergenceError
from midgpt_tpu_torch.robustness.watchdog import StepWatchdog
from midgpt_tpu_torch.training.checkpoint import CheckpointManager
from midgpt_tpu_torch.training.metrics import MetricLogger, Profiler, mfu
from midgpt_tpu_torch.training.optim import Optimizer, OptState, global_norm, make_optimizer

Tensor = torch.Tensor


def health_flag(grads: Params, loss: Tensor, prev_loss: Tensor, mesh: tp.Optional[Mesh] = None) -> Tensor:
    """Sticky post-update health, folded into the reported loss: `loss`
    when this step's gradient leaves and loss AND the previous reported
    loss are finite, else NaN. Leaf-wise finiteness (not the global norm,
    which overflows for large finite gradients that clipping handles);
    sticky because the caller threads the previous reported loss back in.
    Stays on the device: no host sync. On a mesh of several ranks `loss`
    is this rank's (the same on every rank of a tp row and of an ep group)
    and the result is
    the mean over the token shards, each counted once, NaN on every rank
    when any rank saw a non-finite shard, loss or carrier: one all-reduce."""
    grads_ok = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
    if mesh is None or mesh.size == 1:
        healthy = grads_ok & torch.isfinite(loss) & torch.isfinite(prev_loss)
        return torch.where(healthy, loss, torch.full_like(loss, float("nan")))
    sick = ~(grads_ok & torch.isfinite(loss) & torch.isfinite(prev_loss))
    both = mesh.all_reduce_(torch.stack([_row_once(loss, mesh), sick.float()]), mesh.group)
    mean = both[0] / mesh.token_shards
    return torch.where(both[1] == 0, mean, torch.full_like(mean, float("nan")))


def _row_once(t: Tensor, mesh: Mesh) -> Tensor:
    """`t` on the first rank of each tp row and ep group, zero on the
    others: a value every rank of a row (and of an ep group) holds,
    counted once by a sum over the mesh."""
    return t if mesh.tp_index == 0 and mesh.ep_index == 0 else torch.zeros_like(t)


def _generators(
    config: ExperimentConfig, data_step: int, n: int, device, position: int = 0
) -> tp.List[tp.Optional[torch.Generator]]:
    """One dropout generator per microstep, a function of (seed, data step,
    microstep, batch position) so a replayed step draws the same masks,
    the batch positions draw different ones, and the ranks of a tp row the
    same ones (they hold the residual stream whole: masks that differed
    would drive their copies apart); none without dropout."""
    if config.model_config.dropout == 0.0:
        return [None] * n
    # the position's term reaches the low 32 bits: the CPU generator keeps only those of its seed
    seed = (config.seed * 1_000_003 + data_step) * 64 + position * 0x9E3779B1
    return [torch.Generator(device=device).manual_seed(seed + g) for g in range(n)]


def sequence_parallel(model_cfg, mesh: tp.Optional[Mesh],
                      ring_block: tp.Optional[int] = None) -> tp.Callable[[Tensor], tp.Dict[str, tp.Any]]:
    """hooks(x) -> GPT.hidden's sequence-parallel keywords for this rank's
    tokens x (..., Tl): under attn_impl 'ring' or 'ulysses' the schedule
    bound to the mesh's sp group (a group of one at sp 1: the ring's
    diagonal pair, Ulysses' dense attention), the positions
    sp_index*Tl + arange(Tl) and rope_len Tl*sp, as JAX binds them on any
    mesh (train.py:106-131, shard_map_fsdp.py:119-136); no keywords under
    the other impls. The ring's block is `ring_block` (the attn_block_size
    when None); Ulysses' dense attention takes the attn_block_size. Under
    sp > 1 the attention must be one of the two: any other would see only
    the rank's own tokens."""
    sp, index, group = (mesh.sp, mesh.sp_index, mesh.sp_group) if mesh is not None else (1, 0, None)
    if model_cfg.attn_impl == "ring":
        from midgpt_tpu_torch.parallel.ring_attention import ring_attention

        attn_fn = functools.partial(ring_attention, group=group, block_size=ring_block or model_cfg.attn_block_size)
    elif model_cfg.attn_impl == "ulysses":
        from midgpt_tpu_torch.parallel.ulysses import ulysses_attention

        attn_fn = functools.partial(ulysses_attention, group=group, block_size=model_cfg.attn_block_size)
    elif sp > 1:
        raise ValueError(
            f"mesh.sp={sp} trains with attn_impl 'ring' or 'ulysses' (the sequence-parallel attention), got "
            f"{model_cfg.attn_impl!r}"
        )
    else:
        return lambda x: {}

    def hooks(x: Tensor) -> tp.Dict[str, tp.Any]:
        Tl = x.shape[-1]
        return {"attn_fn": attn_fn, "positions": index * Tl + torch.arange(Tl, device=x.device), "rope_len": Tl * sp}

    return hooks


def make_train_step(
    config: ExperimentConfig,
    optimizer: Optimizer,
    mesh: tp.Optional[Mesh] = None,
    specs: tp.Optional[tp.Mapping[str, fsdp.Spec]] = None,
) -> tp.Tuple[tp.Callable, tp.Callable]:
    """(step, eval_loss_many).

    step(params, opt_state, x_GBT, y_GBT, generators=None, prev_loss=0.0)
    -> (params, opt_state, loss): one optimizer step over G microbatches of
    int token tensors on the params' device; params are updated in place.
    On a `mesh`, params and opt_state are this rank's shards under `specs`
    (`state_specs`), the tokens are this rank's rows, and the loss is the
    global batch's (module docstring)."""
    model_cfg = config.model_config
    compute_dtype = getattr(torch, config.compute_dtype)
    G = config.g_accum_iters
    W = mesh.size if mesh is not None else 1
    n_batch = mesh.token_shards if mesh is not None else 1  # the token shards a loss is the mean over
    specs = specs or {}
    tp_train = TPTrain(mesh, specs) if W > 1 and mesh.tp > 1 else None
    ep_train = EPTrain(mesh, specs) if W > 1 and mesh.ep > 1 else None
    # the pipeline gathers each layer over fsdp inside its stages (parallel/pipeline.py)
    pipe = Pipeline(config, mesh, specs, tp_train) if W > 1 and mesh.pp > 1 else None
    sharded = W > 1 and mesh.fsdp > 1 and pipe is None
    vocab_row = tp_train.vocab_row if tp_train is not None else (None, 0)
    sp_hooks = sequence_parallel(model_cfg, mesh)

    # the router's load-balance term (JAX's gate): CE + moe_aux_coef * aux;
    # at a coefficient of 0 the term is never computed and the loss is CE.
    # Its means are the global batch's: summed over the batch positions of
    # this ep index (every ep rank computes the same term from the whole
    # router, and it enters the loss once per ep group)
    use_moe_aux = config.moe_aux_coef != 0.0 and model_cfg.n_experts > 0
    aux_reduce = mesh.psum_batch if use_moe_aux and n_batch > 1 else None

    def head_loss(h: Tensor, head: Tensor, y: Tensor) -> Tensor:
        return fused_linear_cross_entropy(h, head, y, config.loss_chunk_tokens, config.loss_remat_chunks, *vocab_row)

    def loss_fn(params_c: Params, x: Tensor, y: Tensor, generator) -> Tensor:
        h = GPT.hidden(model_cfg, params_c, x, generator=generator, inference=False, return_moe_aux=use_moe_aux,
                       aux_reduce=aux_reduce, tp_train=tp_train, ep_train=ep_train, **sp_hooks(x))
        if use_moe_aux:
            h, aux = h
        ce = head_loss(h, params_c["lm_head"], y)
        return ce + config.moe_aux_coef * aux if use_moe_aux else ce

    if config.fsdp_mode == "shard_map" and W > 1:
        from midgpt_tpu_torch.parallel.shard_map_fsdp import make_shard_map_loss

        schedule = model_cfg.attn_impl if model_cfg.attn_impl in ("ring", "ulysses") else None
        loss_fn = make_shard_map_loss(config, mesh, specs, tp_train, schedule)  # noqa: F811 (takes the shards)

    def value_and_grad(inputs: Params, leaves: Params, x, y, generator) -> tp.Tuple[Tensor, tp.List[Tensor]]:
        """This rank's loss on `inputs` (the gathered copy, or the shards
        under shard_map) and the gradient of the global mean with respect
        to `leaves` (the shards), summed over the mesh: the loss is a mean
        over the data x fsdp x sp token shards (a tp row and an ep group
        share their tokens)."""
        if pipe is not None:  # the schedule takes its own gradients (dropout is 0 under pp)
            loss, grads = pipe.loss_and_grad(inputs, x, y, 1.0 / n_batch)
        else:
            loss = loss_fn(inputs, x, y, generator)
            grads = torch.autograd.grad(loss / n_batch if n_batch > 1 else loss, list(leaves.values()))
        if W > 1:
            fsdp.reduce_grads(dict(zip(leaves, grads)), specs, mesh, tp_partial=HEAD_REGION_LEAVES)
        return loss.detach(), grads

    def step(params: Params, opt_state: OptState, x_GBT: Tensor, y_GBT: Tensor,
             generators=None, prev_loss=0.0):
        generators = generators or [None] * G
        names = list(params)
        # the compute-dtype copy: a new leaf (an alias of the master when
        # the compute dtype is the master's own)
        params_c = {k: v.detach().to(compute_dtype).requires_grad_() for k, v in params.items()}
        # GSPMD mode: every leaf gathered once per step, differentiably
        inputs = params_c
        if sharded and config.fsdp_mode != "shard_map":
            inputs = {k: fsdp.gather(v, specs[k], mesh) for k, v in params_c.items()}
        if G == 1:
            loss, grads = value_and_grad(inputs, params_c, x_GBT[0], y_GBT[0], generators[0])
            grad = {k: g.to(params[k].dtype) for k, g in zip(names, grads)}
        else:
            inv_G = 1.0 / G
            grad = {k: torch.zeros_like(v) for k, v in params.items()}
            losses = []
            for g in range(G):
                loss_g, grads = value_and_grad(inputs, params_c, x_GBT[g], y_GBT[g], generators[g])
                for k, gr in zip(names, grads):
                    grad[k].add_(gr.to(grad[k].dtype) * inv_G)
                losses.append(loss_g)
            loss = torch.stack(losses).mean()
        norm = global_norm(grad, specs, mesh) if W > 1 else None
        opt_state = optimizer.update(grad, opt_state, params, norm=norm)
        prev = torch.as_tensor(prev_loss, dtype=torch.float32, device=loss.device)
        return params, opt_state, health_flag(grad, loss, prev, mesh)

    @torch.no_grad()
    def eval_loss(params_c: Params, x: Tensor, y: Tensor) -> Tensor:
        if pipe is not None:  # GPipe's forward under both schedules, as JAX evaluates
            return pipe.loss(params_c, x, y)
        h = GPT.hidden(model_cfg, params_c, x, inference=True, tp_train=tp_train, ep_train=ep_train, **sp_hooks(x))
        return head_loss(h, params_c["lm_head"], y)

    @torch.no_grad()
    def eval_loss_many(params: Params, x_NBT: Tensor, y_NBT: Tensor) -> Tensor:
        """SUMMED loss over a stacked (N, B, T) eval set (one division at the
        end of `evaluate`, as in JAX); on a mesh, of the global rows: the
        leaves gathered once over fsdp, each token shard's tokens, one
        all-reduce that counts each tp row and ep group once (under pp each
        stage's share of its position's loss)."""
        params_c = {k: v.to(compute_dtype) for k, v in params.items()}
        if sharded:
            params_c = fsdp.gather_tree(params_c, specs, mesh)
        total = torch.zeros((), dtype=torch.float32, device=x_NBT.device)
        for x, y in zip(x_NBT, y_NBT):
            total = total + eval_loss(params_c, x, y)
        if W > 1:
            total = mesh.all_reduce_(_row_once(total, mesh), mesh.group) / n_batch
        return total

    return step, eval_loss_many


def state_specs(config: ExperimentConfig, mesh: tp.Optional[Mesh]) -> tp.Dict[str, fsdp.Spec]:
    """Each leaf's spec on `mesh` (a tuple: 'tp', 'fsdp', 'pp', 'ep' or
    None per axis), JAX's rule (parallel/tp.py `tp_leaf_spec`) at the
    config's shard_model, fsdp_min_size and tp_vocab; at tp 1 and ep 1 the
    FSDP rule; under pp JAX's pipeline rule (parallel/pipeline.py
    `pipeline_param_specs`)."""
    axes = {"tp": mesh.tp if mesh is not None else 1, "fsdp": mesh.fsdp if mesh is not None else 1,
            "ep": getattr(mesh, "ep", 1) if mesh is not None else 1}
    if mesh is not None and getattr(mesh, "pp", 1) > 1:
        return pipeline_param_specs(param_shapes(config.model_config), axes, config.shard_model,
                                    config.fsdp_min_size)
    return tp_param_specs(param_shapes(config.model_config), axes, config.shard_model, config.fsdp_min_size,
                          vocab_parallel=config.tp_vocab)


def init_state(
    config: ExperimentConfig, device: DeviceLike = None, mesh: tp.Optional[Mesh] = None
) -> tp.Tuple[Params, OptState, Optimizer]:
    """Master parameters (GPT.init from config.seed, in param_dtype) and the
    optimizer's zero state, on a `mesh` of several ranks this rank's shards
    of them, sharded at birth (as JAX's init_state never materializes the
    dense state): GPT.init draws every piece in order and keeps the rank's
    slice under `state_specs`, so the shards are the dense init's slices
    bit for bit and a rank holds its shards and one drawn piece at most.
    Returns (params, opt_state, optimizer)."""
    dev = resolve_device(device)
    optimizer, _ = make_optimizer(config)
    shard = None
    if mesh is not None and mesh.size > 1:
        shard = fsdp.ShardedInit(state_specs(config, mesh), mesh, param_shapes(config.model_config))
    params = GPT.init(config.model_config, config.seed, device=dev,
                      dtype=getattr(torch, config.param_dtype), shard=shard)
    return params, optimizer.init(params), optimizer


def _tokens(a: np.ndarray, device) -> Tensor:
    return torch.from_numpy(a).to(device=device, dtype=torch.long)


def evaluate(
    config: ExperimentConfig,
    eval_loss_many: tp.Callable,
    params: Params,
    dataset: TokenDataset,
    split: str,
    step_idx: int,
    mesh: tp.Optional[Mesh] = None,
) -> float:
    """Mean eval loss over `eval_steps` batches (1 under debug), drawn in
    chunks of `eval_host_chunk` batches from the same windows a monolithic
    draw would give; one host sync at the end. On a mesh each rank draws
    its node's batch and evaluates its rows."""
    device = next(iter(params.values())).device
    n = 1 if config.debug else config.eval_steps
    chunk = max(1, min(n, config.eval_host_chunk))
    total = None
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        x, y = dataset.batch(
            split,
            1_000_000_000 + step_idx,  # decorrelated from train batches
            config.model_config.block_size,
            config.batch_size if mesh is None else node_batch_size(config.batch_size, mesh),
            g_accum_iters=n,
            accum_slice=(lo, m),
        )
        if mesh is not None:
            x, y = rank_rows(x, mesh), rank_rows(y, mesh)
        part = eval_loss_many(params, _tokens(x, device), _tokens(y, device))
        total = part if total is None else total + part
    return float(total) / n


def state_template(config: ExperimentConfig) -> tp.Dict[str, tp.Any]:
    """The saved state's restore template: the master parameters' and
    Adam moments' shapes and dtype on the `meta` device (no memory)."""
    dtype = getattr(torch, config.param_dtype)
    shapes = param_shapes(config.model_config)
    like = {k: torch.empty(s, dtype=dtype, device="meta") for k, s in shapes.items()}
    return {"params": like, "opt_state": OptState(0, like, like, 0)}


def _all_finite(params: Params, opt_state: OptState, mesh: tp.Optional[Mesh] = None) -> bool:
    """One device-side finiteness sweep of params and moments, one sync
    (every rank's shards, on a mesh)."""
    leaves = [*params.values(), *opt_state.mu.values(), *opt_state.nu.values()]
    ok = bool(torch.stack([torch.isfinite(t).all() for t in leaves]).all())
    return ok if mesh is None else not mesh.any(not ok)


def train(config: ExperimentConfig, *, device: DeviceLike = None, mesh: tp.Optional[Mesh] = None) -> dict:
    """Run the experiment on one device (CUDA unless told otherwise) or, on
    a `mesh` (default: every rank of the process group, if there is one),
    as one of its ranks; returns {"params", "opt_state", "metrics",
    "resumed_from", "restore_s", "checkpoints"} (this rank's shards; the
    resume step or None, the restore's seconds, one record per save:
    CheckpointManager.history)."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = run_mesh(config, dev)
    lead = mesh.is_leader
    specs = state_specs(config, mesh)
    # each node its slice of the stream, as JAX's trainer gives each process
    dataset = TokenDataset(config.data_dir, seed=config.data_seed, shard_by_process=pdist.n_nodes() > 1)
    optimizer, schedule = make_optimizer(config)
    step, eval_loss_many = make_train_step(config, optimizer, mesh, specs)
    node_bs = node_batch_size(config.batch_size, mesh)
    say = print if lead else (lambda *a, **k: None)

    mngr = None
    first_step, resume_step, restore_s = 0, None, None
    params = opt_state = None
    if not config.debug and config.rundir:
        mngr = CheckpointManager(
            config.rundir,
            max_to_keep=config.ckpt_max_to_keep,
            save_interval_steps=config.eval_interval,
            write_retries=config.ckpt_write_retries,
            retry_backoff_sec=config.ckpt_retry_backoff_sec,
            mesh=mesh,
            specs=specs,
        )
        resume_step = mngr.latest_verified_step()
        if resume_step is not None:
            t0 = time.perf_counter()
            state = mngr.restore(resume_step, state_template(config), device=dev,
                                 select=lambda k, t: fsdp.shard(t, specs[k], mesh))
            params, opt_state = state["params"], state["opt_state"]
            restore_s = time.perf_counter() - t0
            # The manifest guards the bytes; this guards the VALUES (a state
            # saved non-finite by other code): once, at resume.
            if not _all_finite(params, opt_state, mesh):
                raise FloatingPointError(
                    f"checkpoint step {resume_step} in {config.rundir} restored non-finite "
                    "values — it is corrupt; do not resume from it."
                )
            first_step = resume_step + 1
            say(f"resumed from checkpoint step {resume_step} in {config.rundir} "
                f"(restored in {restore_s:.2f} s); training from step {first_step}")
    if params is None:
        params, opt_state, _ = init_state(config, dev, mesh)
    n_params = sum(math.prod(s) for s in param_shapes(config.model_config).values())
    say(f"Model has {n_params - config.model_config.vocab_size * config.model_config.n_embd:,} parameters.")

    logger = MetricLogger("" if config.debug else config.rundir, enabled=lead)
    profiler = Profiler(config.rundir, enabled=config.debug and lead)
    T, G = config.model_config.block_size, config.g_accum_iters
    metrics: tp.Dict[str, tp.Any] = {}
    loss = torch.zeros((), dtype=torch.float32, device=dev)  # sticky health carrier
    t_last, tokens_since = time.time(), 0
    tr = flight_recorder().tracer
    wd = (
        StepWatchdog(config.watchdog_deadline_s, escalate=config.watchdog_escalate,
                     rundir=config.rundir if lead else "")
        if config.watchdog_deadline_s > 0
        else None
    )

    def _sync(t: Tensor, itr: int, data_itr: int) -> float:
        """The loop's host<->device force, watchdog-bounded when armed. The
        `hang_step` fault wedges the force itself (an event nothing sets),
        so only the watchdog's worker-thread inversion ends the wait. The
        force issues no collective: the loss is already the ranks'."""
        hang = faults.should_fire("hang_step", step=data_itr)

        def force() -> float:
            if hang:
                threading.Event().wait()
            return float(t)

        with tr.span("train.sync", "train", "train"):
            return force() if wd is None else wd.sync(force, step=itr, label="train.loss_sync")

    def _last_good(itr: int) -> tp.Optional[int]:
        """The newest verified step, recorded with a divergence instant."""
        last_good = mngr.latest_verified_step() if mngr is not None else None
        tr.instant("train.divergence", "train", "train", args={"step": itr, "last_good": last_good})
        return last_good

    def _draw(split: str, data_itr: int):
        x, y = dataset.batch(split, data_itr, T, node_bs, G)
        return _tokens(rank_rows(x, mesh), dev), _tokens(rank_rows(y, mesh), dev)

    saved_at = None  # the step of the newest save this run started
    try:
        for itr in range(first_step, config.max_steps):
            if itr % config.eval_interval == 0:
                with tr.span("train.eval", "train", "train"):
                    metrics["loss/train"] = evaluate(config, eval_loss_many, params, dataset, "train", itr, mesh)
                    metrics["loss/val"] = evaluate(config, eval_loss_many, params, dataset, "val", itr, mesh)
                logger.log(itr, {k: metrics[k] for k in ("loss/train", "loss/val")})
                t_last, tokens_since = time.time(), 0  # eval pauses don't count

            data_itr = itr + config.data_step_offset
            x, y = _draw("train", data_itr)
            if faults.should_fire("nan_grad", step=data_itr):
                # poison the carrier as a NaN gradient would; no sync
                loss = torch.full((), float("nan"), dtype=torch.float32, device=dev)
            profiler.maybe_start(itr, at_step=first_step + 1)
            with tr.span("train.step", "train", "train"):
                params, opt_state, loss = step(
                    params, opt_state, x, y, _generators(config, data_itr, G, dev, mesh.batch_index), loss,
                )
            profiler.maybe_stop(wait_for=loss)
            if faults.should_fire("preempt", step=data_itr):
                preempt.request()
            if faults.should_fire("resume_reshard", step=data_itr):
                # ends the run like a preemption; chaos_train
                # (robustness/chaos_train.py) resumes it on another rank count
                preempt.request()
            tokens_since += config.batch_size * G * T
            if itr % config.log_interval == 0:
                loss_f = _sync(loss, itr, data_itr)  # the one host sync per log interval
                if not np.isfinite(loss_f):
                    last_good = _last_good(itr)
                    raise DivergenceError(
                        f"non-finite loss ({loss_f}) at step {itr} — training has diverged. "
                        "Last good checkpoint: "
                        + (f"step {last_good} in {config.rundir}" if last_good is not None
                           else "none was saved")
                        + ". Lower learning_rate or raise warmup_steps and resume.",
                        step=itr,
                        last_good_step=last_good,
                        rundir=config.rundir,
                    )
                dt = time.time() - t_last
                tok_s = tokens_since / dt if dt > 0 else 0.0
                t_last, tokens_since = time.time(), 0
                metrics.update({
                    "loss/optimized": loss_f,
                    "lr": schedule(itr),
                    "throughput/tokens_per_sec": tok_s,
                })
                m = mfu(tok_s, config.model_config, dev, n_devices=mesh.size)
                if m is not None:
                    metrics["throughput/mfu"] = m
                logger.log(itr, dict(metrics))
            if mngr is not None and mngr.should_save(itr):
                # One host sync per SAVE interval: never let a poisoned
                # state overwrite the rolling checkpoints.
                if not np.isfinite(_sync(loss, itr, data_itr)):
                    last_good = _last_good(itr)
                    raise DivergenceError(
                        f"non-finite training state at step {itr} — refusing to overwrite the rolling "
                        f"checkpoint. Last good checkpoint: step {last_good} in {config.rundir}. Lower "
                        "learning_rate or raise warmup_steps and resume.",
                        step=itr,
                        last_good_step=last_good,
                        rundir=config.rundir,
                    )
                mngr.save(itr, {"params": params, "opt_state": opt_state})
                saved_at = itr
            if itr % config.preempt_check_interval == 0 and preempt.any_host_requested(mesh):
                grace = config.preempt_grace_s
                req_at = preempt.requested_at()
                # every rank skips, or none does: the save is collective
                save_late = mesh.any(bool(grace > 0 and req_at is not None and time.monotonic() - req_at > grace))
                if save_late:
                    # The grace budget was spent before the save could START:
                    # a multi-second write now risks a kill mid-write. Skip
                    # it loudly; resume falls back to the newest verified step.
                    tr.instant("train.preempt_save_skipped", "train", "train",
                               args={"step": itr, "grace_s": grace})
                    if config.rundir and lead:
                        from midgpt_tpu_torch.robustness import supervisor

                        supervisor.append_note(
                            config.rundir, {"event": "preempt_save_skipped", "step": itr, "grace_s": grace}
                        )
                    say(f"preemption: grace budget ({grace:g}s) already spent at step {itr} — skipping "
                        "the emergency save; resume falls back to the last verified checkpoint")
                elif mngr is not None and saved_at != itr and np.isfinite(_sync(loss, itr, data_itr)):
                    mngr.save(itr, {"params": params, "opt_state": opt_state}, force=True)
                if mngr is not None and not save_late:
                    mngr.wait()  # barrier + manifest: verified before the process exits
                metrics["preempted"] = True
                tr.instant("train.preempt", "train", "train", args={"step": itr})
                if config.rundir and lead:
                    dump_flight_recorder(config.rundir)
                if not save_late:
                    say(f"preemption: emergency checkpoint at step {itr} in "
                        f"{config.rundir or '(no rundir)'}; exiting")
                break

        if not metrics.get("preempted"):
            metrics["loss/final"] = evaluate(
                config, eval_loss_many, params, dataset, "val", config.max_steps, mesh
            )
            logger.log(config.max_steps, {"loss/val_final": metrics["loss/final"]})
            if mngr is not None and first_step < config.max_steps:
                # Force-persist the final state unless the loop's save did, and
                # not if it is poisoned: the sticky loss gates too, since a
                # transient poisoning may leave NaN only in the moments.
                mngr.wait()
                if (
                    mngr.latest_verified_step() != config.max_steps - 1
                    and np.isfinite(metrics["loss/final"])
                    and np.isfinite(float(loss))
                ):
                    mngr.save(config.max_steps - 1, {"params": params, "opt_state": opt_state}, force=True)
    finally:
        # Never abandon an in-flight save: close() joins the writer,
        # raises its error, and garbage-collects.
        logger.close()
        if mngr is not None:
            mngr.close()
    return {
        "params": params, "opt_state": opt_state, "metrics": metrics, "resumed_from": resume_step,
        "restore_s": restore_s, "checkpoints": mngr.history if mngr is not None else [],
    }
