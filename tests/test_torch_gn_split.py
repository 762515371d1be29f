"""Kernel A's split form (statistics, the sums added over the ranks, apply)
against the JAX package's Pallas split form: `_fused_group_norm_impl` with
`psum_axis` runs its two Pallas calls in interpret mode under
`jax.vmap(axis_name="sp")` over the two W blocks stacked, the psum over
the vmap axis standing in for the all-reduce (both cases in one jitted
call: one compile). The port's plain split form
(`group_norm_stats_plain` on each block, the sums added,
`group_norm_apply_plain(shards=2)` on each block) is held to it within
2e-5: float32 on the CPU, sums taken in another order. The second W half
is scaled x3 + 2, so that a half normalised by its own statistics fails
that tolerance, which each case asserts too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.ops import groupnorm
from posetraj_tpu.ops.pallas_groupnorm import _fused_group_norm_impl

GROUPS, EPS, TOL = 8, 1e-5, 2e-5


def _inputs(kind: str):
    """x (2, 4, 16, 64) with a per-sample (2, 64) addend, or (2, 3, 4, 16,
    64) with a per-frame (2, 3, 64) one; weight, bias (64,)."""
    rng = np.random.RandomState(14)
    shape, add_shape = ((2, 4, 16, 64), (2, 64)) if kind == "sample" else ((2, 3, 4, 16, 64), (2, 3, 64))
    x = rng.randn(*shape).astype(np.float32) + 0.5
    x[..., 8:, :] = x[..., 8:, :] * 3.0 + 2.0
    w = (rng.rand(64) + 0.5).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    add = rng.randn(*add_shape).astype(np.float32)
    return x, w, b, add


@pytest.fixture(scope="module")
def pallas_split():
    """Both cases through the JAX package's split form in one jitted vmap
    over the two W blocks stacked: one compile. {kind: (inputs, blocks, y)}."""
    cases = {kind: _inputs(kind) for kind in ("sample", "frame")}
    blocks = {kind: np.stack(np.split(x, 2, axis=-2)) for kind, (x, *_) in cases.items()}

    def rank(xs, xf):
        return tuple(_fused_group_norm_impl(xb, jnp.asarray(cases[k][1]), jnp.asarray(cases[k][2]),
                                            num_groups=GROUPS, eps=EPS, act=True, interpret=True, psum_axis="sp",
                                            add=jnp.asarray(cases[k][3]))
                     for k, xb in (("sample", xs), ("frame", xf)))

    ys = jax.jit(jax.vmap(rank, axis_name="sp"))(jnp.asarray(blocks["sample"]), jnp.asarray(blocks["frame"]))
    return {kind: (cases[kind], blocks[kind], np.concatenate(list(np.asarray(y)), axis=-2))
            for kind, y in zip(("sample", "frame"), ys)}


@pytest.mark.parametrize("kind", ["sample", "frame"])
def test_plain_split_form_matches_the_pallas_split_form(pallas_split, kind):
    (_, w, b, add), blocks, want = pallas_split[kind]
    tw, tb, ta = torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(add)
    halves = [torch.from_numpy(np.ascontiguousarray(h)) for h in blocks]
    sums = sum(groupnorm.group_norm_stats_plain(h, GROUPS, ta) for h in halves)
    got = torch.cat([groupnorm.group_norm_apply_plain(h, tw, tb, sums, GROUPS, EPS, True, ta, shards=2)
                     for h in halves], dim=-2).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # Each half by its own statistics: what a split form that lost the
    # reduction gives. It must miss the tolerance, or the check is blind.
    local = torch.cat([groupnorm.group_norm_apply_plain(h, tw, tb, groupnorm.group_norm_stats_plain(h, GROUPS, ta),
                                                        GROUPS, EPS, True, ta) for h in halves], dim=-2).numpy()
    assert np.abs(local - want).max() > 100 * TOL * max(1.0, np.abs(want).max())
