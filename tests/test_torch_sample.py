"""The port's sampling CLI (`python -m midgpt_tpu_torch.sample`) and its
codec: the HF BPE tokenizer of data/local_text read as JAX's `sample.py`
reads it (sha256-checked; `tokenizers` imported lazily, refused with a
message where it is missing), and the engine choice — batch by default,
continuous exactly where JAX's `sample.py` switches to it."""

import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from midgpt_tpu_torch.config import load_config, to_json
from midgpt_tpu_torch.convert import params_to_numpy
from midgpt_tpu_torch.models.gpt import GPT, GPTConfig
from midgpt_tpu_torch.sample import load_codec, main
from torch_threads import one_thread  # noqa: E402,F401 (autouse: one torch thread)

SHAPE = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=32)
LOCAL_TEXT = "data/local_text"
CHAR = "data/shakespeare_char"
SENTENCE = "The quick brown fox jumps over the lazy dog.\nIt was the best of times, it was the worst of times."


def _char_vocab() -> int:
    with open(f"{CHAR}/meta.pkl", "rb") as f:
        return pickle.load(f)["vocab_size"]


def _run_dir(tmp_path, data_dir, **model_kw):
    """A run directory in the converter's layout (config.json + params.npz)."""
    mc = GPTConfig(**{**SHAPE, **model_kw})
    cfg = load_config("shakespeare_char").replace(data_dir=str(data_dir), compute_dtype="float32", model_config=mc)
    d = tmp_path / "run"
    d.mkdir()
    (d / "config.json").write_text(to_json(cfg))
    np.savez(d / "params.npz", **params_to_numpy(GPT.init(mc, 0, device="cpu")))
    return str(d)


def test_bpe_codec_is_the_datasets_tokenizer():
    from tokenizers import Tokenizer

    tok = Tokenizer.from_file(f"{LOCAL_TEXT}/tokenizer.json")
    encode, decode = load_codec(LOCAL_TEXT)
    ids = encode(SENTENCE)
    assert ids == tok.encode(SENTENCE).ids and len(ids) > 10
    assert decode(ids) == tok.decode(ids, skip_special_tokens=False) == SENTENCE
    # ids past the tokenizer's 50,257 (the model's vocab is 50,304) are dropped, as in JAX
    assert decode(ids + [50300]) == decode(ids)


def test_bpe_codec_refuses_a_changed_tokenizer(tmp_path):
    with open(f"{LOCAL_TEXT}/meta.pkl", "rb") as f:
        meta = pickle.load(f)
    blob = bytearray(open(f"{LOCAL_TEXT}/tokenizer.json", "rb").read())
    blob[len(blob) // 2] ^= 1
    (tmp_path / meta["tokenizer_file"]).write_bytes(bytes(blob))
    (tmp_path / "meta.pkl").write_bytes(pickle.dumps(meta))
    with pytest.raises(ValueError, match="does not match the tokenizer"):
        load_codec(str(tmp_path))


def test_bpe_codec_refuses_without_tokenizers(monkeypatch):
    monkeypatch.setitem(sys.modules, "tokenizers", None)  # `import tokenizers` now raises ImportError
    with pytest.raises(ImportError, match="`tokenizers` package is not installed"):
        load_codec(LOCAL_TEXT)


def test_codec_char_table_and_none(tmp_path):
    encode, decode = load_codec(CHAR)
    assert decode(encode("Hello, world!\n")) == "Hello, world!\n"
    assert load_codec(str(tmp_path)) is None  # no meta.pkl


@pytest.mark.parametrize(
    "flags,engine",
    [
        ([], "batch"),
        (["--spec_layers", "1"], "continuous"),
        (["--draft_ckpt", "RUN"], "continuous"),
        (["--kv_dtype", "int8"], "continuous"),
        (["--spec_layers", "0"], "batch"),
        (["--kv_dtype", "bf16"], "batch"),
        (["--engine", "continuous"], "continuous"),
    ],
    ids=["default", "spec_layers-1", "draft_ckpt", "kv_dtype-int8", "spec_layers-0", "kv_dtype-bf16", "explicit"],
)
def test_engine_choice_follows_jax(tmp_path, capsys, flags, engine):
    run = _run_dir(tmp_path, tmp_path / "no_data")
    flags = [run if f == "RUN" else f for f in flags]
    out = main(["--ckpt_dir", run, "--device", "cpu", "--start_ids", "1,2,3", "--num_samples", "2",
                "--max_new_tokens", "5", "--temperature", "0", *flags])
    assert out["engine"] == engine
    printed = capsys.readouterr().out
    assert ("2 samples on cpu (batch engine)" in printed) == (engine == "batch")
    assert ("2 requests on cpu" in printed) == (engine == "continuous")
    rows = [line for line in printed.splitlines() if line.startswith("1 2 3 ")]
    assert len(rows) == 2 and all(len(r.split()) == 3 + 5 for r in rows)
    assert all(len(s) == 3 + 5 for s in out["streams"])


def test_batch_engine_streams_equal_the_continuous_engines(tmp_path):
    run = _run_dir(tmp_path, tmp_path / "no_data")
    args = ["--ckpt_dir", run, "--device", "cpu", "--start_ids", "5,9,2,7", "--num_samples", "3",
            "--max_new_tokens", "28", "--temperature", "0"]  # 4 + 28 = S = 32: the cache fills
    batch, cont = main(args), main(args + ["--engine", "continuous"])
    assert batch["chunks"] == [16, 8, 2, 1] and batch["overflow_tokens"] == 0 and batch["flash_launches"] == {}
    for b, c in zip(batch["streams"], cont["streams"]):
        np.testing.assert_array_equal(b, c)


def test_start_file_prints_the_decoded_whole_sequences(tmp_path, capsys):
    shutil.copy(f"{CHAR}/meta.pkl", tmp_path / "meta.pkl")
    run = _run_dir(tmp_path, tmp_path, vocab_size=_char_vocab())
    (tmp_path / "prompt.txt").write_text("ROMEO:\nWhat light")
    out = main(["--ckpt_dir", run, "--device", "cpu", f"--start=FILE:{tmp_path / 'prompt.txt'}",
                "--num_samples", "2", "--max_new_tokens", "7", "--temperature", "0"])
    printed = capsys.readouterr().out.split("---------------\n")
    _, decode = load_codec(str(tmp_path))
    assert len(printed) == 3 and out["streams"][0].shape == (len("ROMEO:\nWhat light") + 7,)
    for text, tokens in zip(printed, out["streams"]):
        assert text.startswith("ROMEO:\nWhat light") and text.endswith(decode(tokens.tolist()) + "\n")


def test_bpe_prompt_through_the_cli(tmp_path, capsys):
    run = _run_dir(tmp_path, LOCAL_TEXT, vocab_size=50304)
    out = main(["--ckpt_dir", run, "--device", "cpu", "--start", "Hello there", "--num_samples", "1",
                "--max_new_tokens", "4", "--temperature", "0"])
    encode, decode = load_codec(LOCAL_TEXT)
    stream = out["streams"][0]
    assert stream[: len(encode("Hello there"))].tolist() == encode("Hello there")
    assert decode(stream.tolist()) in capsys.readouterr().out


def test_empty_start_is_a_newline(tmp_path):
    shutil.copy(f"{CHAR}/meta.pkl", tmp_path / "meta.pkl")
    run = _run_dir(tmp_path, tmp_path, vocab_size=_char_vocab())
    out = main(["--ckpt_dir", run, "--device", "cpu", "--start", "", "--num_samples", "1",
                "--max_new_tokens", "2", "--temperature", "0"])
    encode, _ = load_codec(str(tmp_path))
    assert out["streams"][0][:1].tolist() == encode("\n")


def test_defaults_are_jaxs(monkeypatch):
    """--num_samples 10, --max_new_tokens 500, --temperature 0.8, batch."""
    from midgpt_tpu_torch import sample

    seen = {}

    def fake_batch(args, model_cfg, params, prompt, device, decode):
        seen.update(vars(args), rows=prompt.shape[0])
        return {"engine": "batch", "streams": []}

    monkeypatch.setattr(sample, "_batch", fake_batch)
    monkeypatch.setattr(sample, "load_codec", lambda data_dir: (lambda s: [0] * len(s), str))
    monkeypatch.setattr(GPT, "init", staticmethod(lambda *a, **k: {"wte": torch.zeros(1)}))
    sample.main(["--config", "shakespeare_char", "--device", "cpu"])
    assert (seen["num_samples"], seen["max_new_tokens"], seen["temperature"], seen["engine"]) == (10, 500, 0.8, "batch")
    assert seen["rows"] == 10 and seen["start"] == "\n"
