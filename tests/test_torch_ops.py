"""Port parity, numerics layer: midgpt_tpu_torch.ops and the sampling
warp against midgpt_tpu on the same numpy inputs, in float32.

Tolerance: 1e-6 absolute on O(1) values (float32 elementwise math; the two
frameworks' exp/sin/rsqrt may differ in the last ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.ops import norms as jnorms
from midgpt_tpu.ops import online_softmax as jos
from midgpt_tpu.ops import rope as jrope
from midgpt_tpu.ops.attention import visible_mask as j_visible_mask
from midgpt_tpu.sampling.engine import warp_logits as j_warp_logits
from midgpt_tpu_torch.ops import norms as tnorms
from midgpt_tpu_torch.ops import online_softmax as tos
from midgpt_tpu_torch.ops import rope as trope
from midgpt_tpu_torch.ops.attention import visible_mask as t_visible_mask
from midgpt_tpu_torch.sampling.engine import sample_logits as t_sample_logits
from midgpt_tpu_torch.sampling.engine import warp_logits as t_warp_logits

ATOL = 1e-6
CPU = torch.device("cpu")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm_matches_jax(eps):
    x = _rng(1).standard_normal((3, 5, 32)).astype(np.float32)
    w = _rng(2).standard_normal(32).astype(np.float32)
    _close(tnorms.rms_norm(torch.from_numpy(x), eps=eps), jnorms.rms_norm(jnp.asarray(x), eps=eps))
    _close(
        tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=eps),
        jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps=eps),
        atol=4e-6,
    )


def test_head_layer_norm_matches_jax():
    x = (3.0 * _rng(3).standard_normal((2, 4, 3, 16)) + 0.5).astype(np.float32)
    w = _rng(4).standard_normal(16).astype(np.float32)
    _close(
        tnorms.head_layer_norm(torch.from_numpy(x), torch.from_numpy(w)),
        jnorms.head_layer_norm(jnp.asarray(x), jnp.asarray(w)),
        atol=4e-6,
    )


def test_rope_table_matches_jax():
    ts, tc = trope.rope_table(64, 1024, device=CPU)
    js, jc = jrope.rope_table(64, 1024)
    _close(ts, js)
    _close(tc, jc)


def test_split_permutation_and_rotations_match_jax():
    np.testing.assert_array_equal(trope.split_permutation(16), jrope.split_permutation(16))
    x = _rng(5).standard_normal((2, 3, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        trope.rotate_half(torch.from_numpy(x)).numpy(), np.asarray(jrope.rotate_half(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(
        trope.rotate_interleaved(torch.from_numpy(x)).numpy(),
        np.asarray(jrope.rotate_interleaved(jnp.asarray(x))),
    )


@pytest.mark.parametrize("style", ["interleaved", "split"])
@pytest.mark.parametrize("T", [1, 3])
def test_apply_rope_positions_per_slot_matches_jax(style, T):
    x = _rng(6).standard_normal((4, T, 2, 16)).astype(np.float32)
    pos = np.array([[0], [7], [63], [200]]) + np.arange(T)[None]  # per-slot positions
    ts, tc = trope.rope_table(16, 256, device=CPU)
    js, jc = jrope.rope_table(16, 256)
    got = trope.apply_rope_positions(torch.from_numpy(x), ts, tc, torch.from_numpy(pos), style)
    want = jrope.apply_rope_positions(jnp.asarray(x), js, jc, jnp.asarray(pos), style)
    _close(got, want, atol=2e-6)


@pytest.mark.parametrize("style", ["interleaved", "split"])
@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_bthc_matches_jax(style, with_positions):
    x = _rng(7).standard_normal((2, 5, 3, 16)).astype(np.float32)
    ts, tc = trope.rope_table(16, 64, device=CPU)
    js, jc = jrope.rope_table(16, 64)
    pos = np.arange(9, 14) if with_positions else None
    got = trope.apply_rope_bthc(
        torch.from_numpy(x), ts, tc, None if pos is None else torch.from_numpy(pos), style
    )
    want = jrope.apply_rope_bthc(jnp.asarray(x), js, jc, None if pos is None else jnp.asarray(pos), style)
    _close(got, want, atol=2e-6)


def _stats_problem(seed=8):
    r = _rng(seed)
    s = (4 * r.standard_normal((3, 2, 8))).astype(np.float32)
    s[0, 1, :] = tos.MASK  # a fully-masked row
    s[1, 0, 5:] = tos.MASK
    m = np.full((3, 2), tos.M_INIT, np.float32)
    m[2] = 1.5
    l = np.zeros((3, 2), np.float32)
    l[2] = 2.0
    return s, m, l


def test_online_block_matches_jax():
    s, m, l = _stats_problem()
    got = tos.online_block(*(torch.from_numpy(a) for a in (m, l, s)))
    want = jos.online_block(*(jnp.asarray(a) for a in (m, l, s)))
    for g, w in zip(got, want):
        _close(g, w)


def test_merge_partials_and_finalize_match_jax():
    r = _rng(9)
    m = (2 * r.standard_normal((4, 3, 2))).astype(np.float32)
    m[:, 1, 0] = tos.M_INIT  # one partition saw no key at all ...
    l = r.uniform(0.5, 3, (4, 3, 2)).astype(np.float32)
    l[:, 1, 0] = 0.0
    acc = r.standard_normal((4, 3, 2, 16)).astype(np.float32)
    acc[:, 1, 0] = 0.0
    m[:, :, 1] = tos.M_INIT  # ... and one row saw none in any partition
    l[:, :, 1] = 0.0
    acc[:, :, 1] = 0.0
    got = tos.merge_partials(*(torch.from_numpy(a) for a in (m, l, acc)), axis=0)
    want = jos.merge_partials(*(jnp.asarray(a) for a in (m, l, acc)), axis=0)
    for g, w in zip(got, want):
        _close(g, w, atol=4e-6)
    out_t, lse_t = tos.finalize(*got)
    out_j, lse_j = jos.finalize(*want)
    _close(out_t, out_j, atol=4e-6)
    _close(lse_t, lse_j, atol=4e-6)
    assert np.isfinite(out_t.numpy()).all()
    np.testing.assert_array_equal(out_t.numpy()[:, 1], 0.0)  # l == 0 guard
    np.testing.assert_array_equal(lse_t.numpy()[:, 1], np.float32(tos.MASK))


def test_visible_mask_matches_jax():
    col = np.arange(40)[None, :]
    counts = np.array([[0], [1], [17], [40]])
    for w, sinks in [(0, 0), (8, 0), (8, 4)]:
        np.testing.assert_array_equal(
            t_visible_mask(torch.from_numpy(col), torch.from_numpy(counts), w, sinks).numpy(),
            np.asarray(j_visible_mask(jnp.asarray(col), jnp.asarray(counts), w, sinks)),
        )


@pytest.mark.parametrize(
    "temperature,top_k,top_p", [(0.7, None, None), (1.3, 5, None), (0.9, None, 0.8), (1.0, 10, 0.5)]
)
def test_warp_logits_matches_jax(temperature, top_k, top_p):
    x = (3 * _rng(10).standard_normal((3, 64))).astype(np.float32)
    got = t_warp_logits(torch.from_numpy(x), temperature, top_k, top_p).numpy()
    want = np.asarray(j_warp_logits(jnp.asarray(x), temperature, top_k, top_p))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], atol=ATOL, rtol=0)


def test_greedy_sampling_is_first_index_argmax():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert t_sample_logits(logits, 0.0).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    drawn = t_sample_logits(logits, 1.0, top_k=1, generator=gen)
    assert drawn.tolist()[0] in (1, 2)  # top-1 keeps both tied maxima
