"""Convert a JAX run's checkpoint step into a step directory of the
PyTorch port, in one command.

    JAX_PLATFORMS=cpu python tools/jax_to_port.py --jax_rundir=outputs/jax_run \\
        --out=outputs/from_jax [--step N]

Reads the JAX run directory's `config.json`, restores step N (default:
the newest verified step) with midgpt_tpu's CheckpointManager onto the
host CPU, flattens the parameters and the optax state, and writes `<out>/N/`
in the port's checkpoint layout (midgpt_tpu_torch/convert.py `write_step`,
`opt_state_from_optax`) with the run's `config.json` beside it (its
`rundir` set to `out`). Every layout converts by leaf name: MHA, GQA's
`wkv` and the routed MLP's `router`, `experts_up` and `experts_down`.

Then the port's launcher resumes at step N + 1 from `--rundir=<out>` (with
the run's settings as `--set` overrides of a preset), and
`python -m midgpt_tpu_torch.sample --ckpt_dir=<out>` serves it. This
script imports JAX; the port itself never does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import typing as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _flatten(tree) -> tp.Dict[str, tp.Any]:
    import jax
    import numpy as np

    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}


def convert(jax_rundir: str, out: str, step: tp.Optional[int] = None) -> tp.Tuple[int, str]:
    """Write `out/<step>/` and `out/config.json` from the JAX run's step
    (the newest verified one by default); returns (step, step directory)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")  # a host-side conversion: restore onto the CPU
    from midgpt_tpu.config import from_json as j_from_json
    from midgpt_tpu.models.gpt import GPT as JGPT
    from midgpt_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
    from midgpt_tpu.training.optim import make_optimizer as j_make_optimizer
    from midgpt_tpu_torch.config import from_json
    from midgpt_tpu_torch.convert import opt_state_from_optax, write_step

    with open(os.path.join(jax_rundir, "config.json")) as f:
        text = f.read()
    jconfig = j_from_json(text)
    raw = json.loads(text)
    raw["rundir"] = os.path.abspath(out)
    config = from_json(json.dumps(raw))  # the port validates the run's config before anything is written

    dtype = jnp.dtype(jconfig.param_dtype)
    params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, dtype),
                          jax.eval_shape(lambda k: JGPT.init(jconfig.model_config, k), jax.random.PRNGKey(0)))
    optimizer, _ = j_make_optimizer(jconfig)
    opt_state = jax.eval_shape(optimizer.init, params)
    mngr = JCheckpointManager(jax_rundir)
    try:
        if step is None:
            step = mngr.latest_verified_step()
            if step is None:
                raise SystemExit(f"no verified checkpoint step under {jax_rundir}")
        state = mngr.restore(step, {"params": params, "opt_state": opt_state})
    finally:
        mngr.close()
    moments = opt_state_from_optax(_flatten(state["opt_state"]), config=config.model_config, device="cpu")
    step_dir = write_step(out, step, _flatten(state["params"]), moments)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(raw, f, indent=2)
    return step, step_dir


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--jax_rundir", required=True, help="a JAX run directory: config.json and checkpoint steps")
    parser.add_argument("--out", required=True, help="the port's run directory to write")
    parser.add_argument("--step", type=int, default=None, help="the step to convert (default: newest verified)")
    args = parser.parse_args(argv)
    step, step_dir = convert(args.jax_rundir, args.out, args.step)
    print(f"converted step {step} of {args.jax_rundir} to {step_dir} (config.json beside it)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
