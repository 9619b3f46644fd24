"""Serve samples through the continuous-batching engine (counterpart of
`sample.py --engine=continuous`).

    python -m midgpt_tpu_torch.sample --config=openwebtext --start_ids=50256 \\
        [--seed=0] [--num_samples=4] [--max_new_tokens=64] [--max_slots=4] \\
        [--temperature=0.8] [--top_k=K] [--top_p=P] [--device=cuda] \\
        [--spec_layers=N] [--kv_dtype={bf16,int8}] [--draft_ckpt=<run>]
    python -m midgpt_tpu_torch.sample --ckpt_dir=<run> ...

`--config` serves random weights made from `--seed` (the way
tools/bench_serve.py serves random-init models); `--ckpt_dir` reads a
run directory's `config.json` and the parameters of its newest verified
checkpoint step (training/checkpoint.py; a directory whose steps all fail
verification is refused), or, where it has no step directory at all, a
bare `params.npz` in the converter's layout (midgpt_tpu_torch/convert.py:
weights handed over from a JAX run). Each sample is an independent
request. Prompts use the dataset's char codec when the config's
`data_dir/meta.pkl` is a char table, else `--start_ids` (comma-separated
token ids). Runs on CUDA unless `--device cpu` is given.

Speculative decoding and the paged cache's dtype follow the config
(`spec_layers`, `spec_k_max`, `spec_k_min`, `spec_adapt`,
`kv_cache_dtype`), as JAX's `sample.py --engine=continuous` does:
`local_text_124m` ships spec_layers=4, so it is served with a 4-layer
self-draft unless `--spec_layers 0` turns it off. `--draft_ckpt` takes a
separate draft model's run directory instead.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--config", type=str, help="named preset (midgpt_tpu_torch/configs)")
    src.add_argument("--ckpt_dir", type=str, help="run dir with config.json + checkpoint steps (or params.npz)")
    parser.add_argument("--seed", type=int, default=0, help="weights (--config) and sampling seed")
    parser.add_argument("--start", type=str, default="\n", help="prompt text (char codec only)")
    parser.add_argument("--start_ids", type=str, default=None, help="comma-separated prompt token ids")
    parser.add_argument("--num_samples", type=int, default=4)
    parser.add_argument("--max_new_tokens", type=int, default=64)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--top_p", type=float, default=None, help="nucleus sampling mass")
    parser.add_argument("--max_slots", type=int, default=4, help="concurrent decode slots")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--spec_layers", type=int, default=None,
        help="speculative decoding with a SELF-DRAFT of this many leading layers "
        "(shared embeddings/lm_head, sampling/spec.py). Default: the config's "
        "spec_layers; 0 turns it off",
    )
    parser.add_argument(
        "--kv_dtype", choices=("bf16", "int8"), default=None,
        help="paged KV cache storage dtype. Default: the config's kv_cache_dtype",
    )
    parser.add_argument(
        "--draft_ckpt", type=str, default=None,
        help="speculative decoding with a SEPARATE draft run dir (as --ckpt_dir; "
        "same vocab and block_size); excludes --spec_layers",
    )
    args = parser.parse_args(argv)
    if args.draft_ckpt is not None and args.spec_layers:
        parser.error("--draft_ckpt and --spec_layers are mutually exclusive")

    import numpy as np
    import torch

    from midgpt_tpu_torch.config import from_json, load_config
    from midgpt_tpu_torch.convert import load_npz
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.sampling.engine import restore_for_sampling
    from midgpt_tpu_torch.sampling.serve import ServeEngine
    from midgpt_tpu_torch.sampling.spec import self_draft
    from midgpt_tpu_torch.utils.precision import cast_floating

    def read_run(run_dir):
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = from_json(f.read())
        if not any(name.isdigit() for name in os.listdir(run_dir)):  # weights handed over as params.npz
            return cfg, load_npz(os.path.join(run_dir, "params.npz"), config=cfg.model_config, device=device)
        return cfg, restore_for_sampling(run_dir, cfg, device)[0]

    device = resolve_device(args.device)
    if args.config is not None:
        config = load_config(args.config)
        params = GPT.init(config.model_config, args.seed, device=device)
    else:
        config, params = read_run(args.ckpt_dir)
    compute_dtype = getattr(torch, config.compute_dtype)
    params = cast_floating(params, compute_dtype)
    model_cfg = config.model_config

    draft_config = draft_params = None
    draft_shares_cache = False
    spec_layers = config.spec_layers if args.spec_layers is None else args.spec_layers
    if args.draft_ckpt is not None:
        draft_exp, draft_params = read_run(args.draft_ckpt)
        draft_config = draft_exp.model_config
        draft_params = cast_floating(draft_params, compute_dtype)
        print(f"draft model: {args.draft_ckpt}")
    elif spec_layers:
        draft_config, draft_params = self_draft(model_cfg, params, spec_layers)
        draft_shares_cache = True  # the prefix layers ride the target pool
        print(f"self-draft: first {spec_layers}/{model_cfg.n_layer} layers")
    kv_dtype = config.kv_cache_dtype if args.kv_dtype is None else args.kv_dtype

    meta_path = os.path.join(config.data_dir, "meta.pkl")
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)  # the dataset's own codec file
    if meta is not None and meta.get("kind") != "hf_bpe" and "stoi" in meta:
        stoi, itos = meta["stoi"], meta["itos"]
        start_ids = [stoi[c] for c in (args.start or "\n")]
        decode = lambda ids: "".join(itos[i] for i in ids)
    else:
        if args.start_ids is None:
            parser.error(
                f"{config.data_dir} has no char codec; pass --start_ids "
                "(the BPE codecs are not ported yet)"
            )
        start_ids = [int(t) for t in args.start_ids.split(",")]
        decode = lambda ids: " ".join(str(i) for i in ids)

    eng = ServeEngine(
        model_cfg,
        params,
        max_slots=args.max_slots,
        cache_dtype=kv_dtype,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        seed=args.seed,
        device=device,
        draft_params=draft_params,
        draft_config=draft_config,
        draft_shares_cache=draft_shares_cache,
        spec_k_max=config.spec_k_max,
        spec_k_min=config.spec_k_min,
        spec_adapt=config.spec_adapt,
    )
    prompt = np.asarray(start_ids, np.int32)
    uids = [eng.submit(prompt, args.max_new_tokens) for _ in range(args.num_samples)]
    t0 = time.perf_counter()
    finished = eng.run()
    wall = time.perf_counter() - t0
    for u in uids:
        print(decode(finished[u].tokens.tolist()))
        print("---------------")
    st = eng.stats()
    print(
        f"{len(uids)} requests on {device}: {st['decode_tokens']} decode tokens "
        f"in {st['decode_seconds']:.3f} s of decode rounds, {wall:.3f} s wall; "
        f"preemptions {st['preemptions']}; kv cache {kv_dtype}"
        + (f"; window_reclaimed_pages {st['window_reclaimed_pages']}" if model_cfg.sliding_window else "")
    )
    if draft_params is not None:
        s = eng.spec_stats()
        print(
            f"speculative: {s['rounds']} verify rounds, accept_rate {s['accept_rate']:.2f}, "
            f"tokens/verify {s['tokens_per_verify']:.2f}"
        )


if __name__ == "__main__":
    main()
