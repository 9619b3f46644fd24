"""Sample from a model (counterpart of the root `sample.py`).

    python -m midgpt_tpu_torch.sample --config=local_text_124m --start="Once upon a time" \\
        [--engine={batch,continuous}] [--seed=0] [--num_samples=10] [--max_new_tokens=500] \\
        [--temperature=0.8] [--top_k=K] [--top_p=P] [--device=cuda] [--start_ids=1,2,3] \\
        [--max_slots=4] [--spec_layers=N] [--kv_dtype={bf16,int8}] [--draft_ckpt=<run>]
    python -m midgpt_tpu_torch.sample --ckpt_dir=<run> ...

`--config` serves random weights made from `--seed` (the way
tools/bench_serve.py serves random-init models); `--ckpt_dir` reads a
run directory's `config.json` and the parameters of its newest verified
checkpoint step (training/checkpoint.py; a directory whose steps all fail
verification is refused), or, where it has no step directory at all, a
bare `params.npz` in the converter's layout (midgpt_tpu_torch/convert.py:
weights handed over from a JAX run). Runs on CUDA unless `--device cpu` is
given.

Two engines, as in JAX. `batch` (the default) tiles the prompt to
`num_samples` rows and runs them through `sampling/engine.py generate`:
one prefill, then decode chunks against the contiguous cache.
`continuous` serves each sample as an independent request through the
paged engine (sampling/serve.py); there speculative decoding and the
paged cache's dtype follow the config (`spec_layers`, `spec_k_max`,
`spec_k_min`, `spec_adapt`, `kv_cache_dtype`). `--spec_layers N` with N >
0, `--draft_ckpt` and `--kv_dtype int8` imply `continuous`, exactly as in
JAX.

Prompts go through the dataset's codec (`load_codec`, in JAX's order: the
HF BPE tokenizer a `meta.pkl` of kind "hf_bpe" names, checked against its
sha256; else the char table), and each row is printed as the decoded whole
sequence. `--start_ids` (comma-separated token ids) bypasses the codec:
ids in, ids out. Where the dataset has no codec the port reads, it is
required (JAX's fallback, tiktoken's GPT-2 BPE, needs a BPE file the
repository does not hold).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pickle
import time
import typing as tp

Codec = tp.Tuple[tp.Callable[[str], tp.List[int]], tp.Callable[[tp.List[int]], str]]


def load_codec(data_dir: str) -> tp.Optional[Codec]:
    """(encode, decode) of the dataset in `data_dir`, read from its
    meta.pkl: the HF BPE tokenizer of kind "hf_bpe" (its file checked
    against the sha256 the dataset recorded; `tokenizers` imported here,
    and never installed), else the char table. None where there is no
    meta.pkl or it holds neither."""
    meta_path = os.path.join(data_dir, "meta.pkl")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path, "rb") as f:
        meta = pickle.load(f)  # the dataset's own codec file
    if meta.get("kind") == "hf_bpe":
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(
                f"{data_dir} is encoded with an HF BPE tokenizer and the `tokenizers` package is not "
                "installed; install it, or pass --start_ids"
            ) from e
        tok_path = os.path.join(data_dir, meta["tokenizer_file"])
        want_sha = meta.get("tokenizer_sha256")
        if want_sha is not None:
            with open(tok_path, "rb") as f:
                got_sha = hashlib.sha256(f.read()).hexdigest()
            if got_sha != want_sha:
                raise ValueError(
                    f"{tok_path} does not match the tokenizer this dataset (and any checkpoint trained "
                    "on it) was built with — decoding would be silently wrong. Re-run the dataset's "
                    "prepare.py."
                )
        tok = Tokenizer.from_file(tok_path)
        return (lambda s: tok.encode(s).ids), (lambda ids: tok.decode(ids, skip_special_tokens=False))
    if "stoi" in meta:
        stoi, itos = meta["stoi"], meta["itos"]
        return (lambda s: [stoi[c] for c in s]), (lambda ids: "".join(itos[i] for i in ids))
    return None


def main(argv=None) -> dict:
    """Sample; returns the engine's name ("engine") and each sample's
    tokens ("streams"), and besides: for the batch engine the wall, prefill
    and decode seconds, the decode tokens, the chunk lengths dispatched,
    the decode-step graphs captured and replayed, and the flash forward's
    launches by dispatch; for the continuous engine its `stats()`, the
    seconds to make the weights, pool and engine, the weights' bytes and
    the wall seconds of `run`."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--config", type=str, help="named preset (midgpt_tpu_torch/configs)")
    src.add_argument("--ckpt_dir", type=str, help="run dir with config.json + checkpoint steps (or params.npz)")
    parser.add_argument("--seed", type=int, default=0, help="weights (--config) and sampling seed")
    parser.add_argument("--start", type=str, default="\n", help='prompt text, or FILE:path ("" is "\\n")')
    parser.add_argument("--start_ids", type=str, default=None, help="comma-separated prompt token ids (no codec)")
    parser.add_argument("--num_samples", type=int, default=10)
    parser.add_argument("--max_new_tokens", type=int, default=500)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--top_p", type=float, default=None, help="nucleus sampling mass")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument(
        "--engine", choices=("batch", "continuous"), default="batch",
        help="'batch': one (num_samples, T) batch through the contiguous-cache loop; 'continuous': "
        "each sample an independent request on the paged continuous-batching engine",
    )
    parser.add_argument("--max_slots", type=int, default=4, help="continuous engine: concurrent decode slots")
    parser.add_argument(
        "--spec_layers", type=int, default=None,
        help="speculative decoding with a SELF-DRAFT of this many leading layers "
        "(shared embeddings/lm_head, sampling/spec.py). Default: the config's "
        "spec_layers (continuous engine); 0 turns it off. N > 0 implies --engine=continuous",
    )
    parser.add_argument(
        "--kv_dtype", choices=("bf16", "int8"), default=None,
        help="paged KV cache storage dtype. Default: the config's kv_cache_dtype "
        "(continuous engine). int8 implies --engine=continuous",
    )
    parser.add_argument(
        "--draft_ckpt", type=str, default=None,
        help="speculative decoding with a SEPARATE draft run dir (as --ckpt_dir; "
        "same vocab and block_size); excludes --spec_layers. Implies --engine=continuous",
    )
    args = parser.parse_args(argv)
    if args.draft_ckpt is not None and args.spec_layers:
        parser.error("--draft_ckpt and --spec_layers are mutually exclusive")
    if args.draft_ckpt is not None or args.spec_layers or args.kv_dtype == "int8":
        args.engine = "continuous"  # speculation and the quantized cache live in the paged engine

    import numpy as np
    import torch

    from midgpt_tpu_torch.config import from_json, load_config
    from midgpt_tpu_torch.convert import load_npz
    from midgpt_tpu_torch.device import resolve_device
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.sampling.engine import restore_for_sampling
    from midgpt_tpu_torch.utils.precision import cast_floating

    def read_run(run_dir):
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = from_json(f.read())
        if not any(name.isdigit() for name in os.listdir(run_dir)):  # weights handed over as params.npz
            return cfg, load_npz(os.path.join(run_dir, "params.npz"), config=cfg.model_config, device=device)
        return cfg, restore_for_sampling(run_dir, cfg, device)[0]

    device = resolve_device(args.device)
    t_init = time.perf_counter()
    if args.config is not None:
        config = load_config(args.config)
        # made in the compute dtype: a 7B model's f32 copy never exists
        params = GPT.init(config.model_config, args.seed, device=device,
                          dtype=getattr(torch, config.compute_dtype))
    else:
        config, params = read_run(args.ckpt_dir)
    compute_dtype = getattr(torch, config.compute_dtype)
    params = cast_floating(params, compute_dtype)
    model_cfg = config.model_config

    if args.start_ids is not None:
        start_ids = [int(t) for t in args.start_ids.split(",")]
        decode = lambda ids: " ".join(str(i) for i in ids)  # noqa: E731
    else:
        codec = load_codec(config.data_dir)
        if codec is None:
            parser.error(
                f"{config.data_dir} has no codec the port reads (meta.pkl with a char table or an HF BPE "
                "tokenizer); pass --start_ids"
            )
        encode, decode = codec
        start = args.start
        if start.startswith("FILE:"):
            with open(start[5:], "r", encoding="utf-8") as f:
                start = f.read()
        start_ids = encode(start if start != "" else "\n")
    prompt = np.tile(np.asarray(start_ids, np.int64), (args.num_samples, 1))

    if args.engine == "batch":
        return _batch(args, model_cfg, params, prompt, device, decode)
    return _continuous(args, config, params, prompt, device, decode, read_run, t_init)


def _print_streams(streams, decode) -> None:
    for tokens in streams:
        print(decode(tokens.tolist()))
        print("---------------")


def _batch(args, model_cfg, params, prompt, device, decode) -> dict:
    import torch

    from midgpt_tpu_torch.kernels import flash_attention as fa
    from midgpt_tpu_torch.sampling.engine import generate

    flash_before = fa.FWD_LAUNCHES.by_variant.copy()
    stats = {}
    t0 = time.perf_counter()
    out = generate(
        model_cfg, params, prompt, args.max_new_tokens, temperature=args.temperature, top_k=args.top_k,
        top_p=args.top_p, generator=torch.Generator(device).manual_seed(args.seed), device=device, stats=stats,
    )
    wall = time.perf_counter() - t0
    flash = dict(fa.FWD_LAUNCHES.by_variant - flash_before)
    _print_streams(out, decode)
    decode_tokens = args.num_samples * (args.max_new_tokens - 1)
    print(
        f"{args.num_samples} samples on {device} (batch engine): prefill of {prompt.shape[1]} tokens "
        f"{1e3 * stats['prefill_s']:.1f} ms; {decode_tokens} decode tokens in {stats['decode_s']:.3f} s "
        f"({stats['overflow_tokens']} past the cache); {wall:.3f} s wall; chunks {stats['chunks']}; "
        f"decode-step graphs captured {stats['captures']}, replays {stats['replays']}"
    )
    return {"engine": "batch", "streams": list(out.numpy()), "wall_s": wall, "decode_tokens": decode_tokens,
            "flash_launches": flash, **stats}


def _continuous(args, config, params, prompt, device, decode, read_run, t_init) -> dict:
    import torch

    from midgpt_tpu_torch.sampling.serve import ServeEngine
    from midgpt_tpu_torch.sampling.spec import self_draft
    from midgpt_tpu_torch.utils.precision import cast_floating

    model_cfg = config.model_config
    compute_dtype = getattr(torch, config.compute_dtype)
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
    init_s = time.perf_counter() - t_init
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    print(f"weights: {weight_bytes:,} bytes ({str(compute_dtype)[6:]}); paged pool "
          f"{eng.cache_hbm_bytes():,} bytes ({kv_dtype}); weights, pool and engine made in {init_s:.2f} s")
    uids = [eng.submit(row.astype("int32"), args.max_new_tokens) for row in prompt]
    t0 = time.perf_counter()
    finished = eng.run()
    wall = time.perf_counter() - t0
    streams = [finished[u].tokens for u in uids]
    _print_streams(streams, decode)
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
    return {"engine": "continuous", "stats": st, "init_s": init_s, "weight_bytes": weight_bytes, "wall_s": wall,
            "streams": streams}


if __name__ == "__main__":
    main()
