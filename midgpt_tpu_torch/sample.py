"""Serve samples through the continuous-batching engine (counterpart of
`sample.py --engine=continuous`).

    python -m midgpt_tpu_torch.sample --config=openwebtext --start_ids=50256 \\
        [--seed=0] [--num_samples=4] [--max_new_tokens=64] [--max_slots=4] \\
        [--temperature=0.8] [--top_k=K] [--top_p=P] [--device=cuda]
    python -m midgpt_tpu_torch.sample --ckpt_dir=<run> ...

`--config` serves random weights made from `--seed` (the way
tools/bench_serve.py serves random-init models); `--ckpt_dir` reads a
run directory holding `config.json` and `params.npz` in the converter's
layout (midgpt_tpu_torch/convert.py). Each sample is an independent
request. Prompts use the dataset's char codec when the config's
`data_dir/meta.pkl` is a char table, else `--start_ids` (comma-separated
token ids). Runs on CUDA unless `--device cpu` is given.
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
    src.add_argument("--ckpt_dir", type=str, help="run dir with config.json + params.npz")
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
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from midgpt_tpu_torch.config import from_json, load_config
    from midgpt_tpu_torch.convert import load_npz
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.sampling.serve import ServeEngine
    from midgpt_tpu_torch.utils.precision import cast_floating

    device = resolve_device(args.device)
    if args.config is not None:
        config = load_config(args.config)
        params = GPT.init(config.model_config, args.seed, device=device)
    else:
        with open(os.path.join(args.ckpt_dir, "config.json")) as f:
            config = from_json(f.read())
        params = load_npz(os.path.join(args.ckpt_dir, "params.npz"), device=device)
    params = cast_floating(params, getattr(torch, config.compute_dtype))
    model_cfg = config.model_config

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
        cache_dtype=config.kv_cache_dtype,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        seed=args.seed,
        device=device,
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
        f"preemptions {st['preemptions']}"
    )


if __name__ == "__main__":
    main()
