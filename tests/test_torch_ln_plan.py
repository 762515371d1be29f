"""The launch plan of kernel 8 (ops/layernorm.plan): lanes a row, vectors a
lane and the persistent grid, for an H100 (132 SMs) at the main paths'
shapes, then its rules over a sweep of widths, both dtypes and ragged row
counts. The CTAs an SM holds come from the compiled library on the card;
here they are given. CPU only, no JAX."""

import pytest
import torch

from posetraj_torch.ops import layernorm

SMS = 132
WIDTHS = (8, 40, 320, 328, 640, 1280, 2040, 2048)


@pytest.mark.parametrize("m,c,dtype,ctas,want", [
    (80640, 320, torch.bfloat16, 4, (8, 4, 5, 528)),    # level 0 of 14x320x576: four rows a warp
    (20160, 640, torch.bfloat16, 4, (16, 2, 5, 528)),   # level 1
    (5040, 1280, torch.bfloat16, 4, (32, 1, 5, 528)),   # level 2: a row a warp
    (258048, 320, torch.bfloat16, 4, (8, 4, 5, 528)),   # the temp hint's block LayerNorms
    (20160, 640, torch.float32, 5, (32, 1, 5, 660)),    # level 1 in float32
    (4096, 2048, torch.float32, 2, (32, 1, 16, 264)),   # the widest: 16 vectors a lane
    (7, 320, torch.bfloat16, 4, (8, 4, 5, 1)),          # two groups of rows: one warp, one CTA
])
def test_plan_at_the_main_paths_shapes(m, c, dtype, ctas, want):
    p = layernorm.plan(m, c, dtype, SMS, ctas)
    assert (p.lanes, p.rows, p.vecs, p.grid) == want


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 4097, 80641])
def test_plan_rules(m, c, dtype):
    ctas = 4
    p = layernorm.plan(m, c, dtype, SMS, ctas)
    per_vec = layernorm.VEC_BYTES // dtype.itemsize
    nv = c // per_vec
    # A power-of-two group of lanes, a whole number of rows a warp.
    assert p.lanes in (1, 2, 4, 8, 16, 32) and p.rows * p.lanes == 32
    # The group divides the row's vectors, unless the last round is ragged:
    # then the whole warp takes the row, because no power of two that
    # divides nv leaves a lane at most max_vecs vectors.
    if nv % p.lanes == 0:
        assert p.vecs == nv // p.lanes
    else:
        assert p.lanes == 32 and nv // (nv & -nv) > layernorm.max_vecs(dtype.itemsize)
    assert 1 <= p.vecs <= layernorm.max_vecs(dtype.itemsize)
    # Every column of a row exactly once: lane `sub` holds vectors
    # sub + lanes * i, i < vecs, that fall inside the row.
    cols = [v * per_vec + e for sub in range(p.lanes) for i in range(p.vecs)
            for v in [sub + p.lanes * i] if v < nv for e in range(per_vec)]
    assert sorted(cols) == list(range(c))
    # The row a lane holds in float32 registers: at most 64 of a thread's
    # 255, so that the next row's vectors and the statistics fit beside it.
    assert p.vecs * per_vec <= 64
    # The grid: no more CTAs than the SMs hold at once, none without rows,
    # and its warps walk every group of rows (warp w takes groups w, w +
    # warps, ...).
    warps = p.grid * layernorm.THREADS // 32
    groups = -(-m // p.rows)
    assert 1 <= p.grid <= ctas * SMS
    assert (p.grid - 1) * layernorm.THREADS // 32 < groups
    taken = sorted(g for w in range(min(warps, groups)) for g in range(w, groups, warps))
    assert taken == list(range(groups))


@pytest.mark.parametrize("c", [4, 12, 330, 2056, 4096, 0])
def test_plan_refuses_widths_the_kernel_does_not_take(c):
    with pytest.raises(ValueError, match="multiple of 8"):
        layernorm.plan(4096, c, torch.bfloat16, SMS, 4)
