"""The launch schedule of kernel A (ops/groupnorm.schedule): one cooperative
launch of at most two CTAs an SM, split into teams that each own one
sample at a time, as many teams as samples that the grid's shared memory
holds at once. Values for an H100 (132 SMs) at the shapes of the main
paths; then the rules on a sweep of shapes. Then the split form's
schedule (split_grid, split_ctas_a_sample): one wave of CTAs on balanced ranges
of the flattened rows, the occupancy given. CPU only, no JAX."""

import pytest

from posetraj_torch.ops import groupnorm

SMS = 132


@pytest.mark.parametrize("shape,itemsize,want", [
    ((28, 72 * 128, 320), 2, (264, 4)),      # UNet level 0 at 576x1024: 61 CTAs a sample, 7 rounds of 4
    ((28, 36 * 64, 640), 2, (264, 7)),       # level 1: 31 CTAs a sample, 4 rounds of 7
    ((28, 18 * 32, 1280), 2, (264, 14)),     # level 2: 16 CTAs a sample, 2 rounds of 14
    ((28, 9 * 16, 1280), 2, (264, 28)),      # level 3: one round
    ((2, 14 * 72 * 128, 320), 2, (264, 1)),  # temporal resnet's per-frame fold: 83 MB a sample, streamed
    ((1, 576 * 1024, 128), 4, (264, 1)),     # float32 VAE encode: 302 MB, streamed
    ((2, 3 * 16 * 16, 64), 2, (24, 2)),      # a card test's tiny shape: 8 KB a CTA
    ((4, 1024, 4096), 2, (264, 2)),          # 8 KB rows, the widest: 86 CTAs a sample, 2 rounds of 2
])
def test_schedule_at_the_main_paths_shapes(shape, itemsize, want):
    assert groupnorm.schedule(*shape, itemsize, 32, SMS) == want


@pytest.mark.parametrize("n", [1, 2, 3, 5, 14, 28, 29])
@pytest.mark.parametrize("s,c", [(1, 64), (45, 320), (2880, 320), (9216, 320), (589824, 128)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_schedule_rules(n, s, c, itemsize):
    grid, teams = groupnorm.schedule(n, s, c, itemsize, 32, SMS)
    assert 1 <= teams <= min(n, grid) and grid <= min(groupnorm.CTAS_PER_SM * SMS, groupnorm.MAX_TEAMS)
    rounds = -(-n // teams)
    assert (teams - 1) * rounds < n <= teams * rounds  # every team takes `rounds` or `rounds - 1` samples
    held = groupnorm.SLOTS * (groupnorm.SLOT_BYTES // (c * itemsize))  # rows a CTA holds in shared memory
    assert teams == 1 or (grid // teams) * held >= s  # a team of several holds its sample


def test_schedule_refuses_rows_wider_than_its_threads():
    with pytest.raises(ValueError, match="row"):
        groupnorm.schedule(1, 4, 4104, 2, 32, SMS)
    with pytest.raises(ValueError, match="row"):
        groupnorm.schedule(1, 4, 2056, 4, 32, SMS)


# The split form's rank-local shapes on the sharded path at 14x576x1024:
# level 0 over (2, 4) and the full level 0 over (1, 1) as a (1, 2) rank
# takes it, the deepest level over sp = 4, a temporal resnet's per-frame
# fold (n = 1), the CFG batch of 28 on (1, x) meshes; a ragged row count.
@pytest.mark.parametrize("n,s,c,itemsize", [
    (14, 72 * 32, 320, 2),
    (28, 72 * 64, 320, 2),
    (14, 9 * 4, 1280, 2),
    (28, 9 * 8, 2560, 2),
    (1, 14 * 72 * 32, 320, 2),
    (2, 14 * 18 * 16, 1280, 2),
    (3, 37 * 41, 128, 4),
    (1, 1, 64, 2),
])
@pytest.mark.parametrize("ctas_per_sm", [1, 2, 3])
def test_split_schedule_one_wave_of_balanced_ranges(n, s, c, itemsize, ctas_per_sm):
    """split_grid: at most one wave of co-resident CTAs and at most one row a
    thread; CTA b's rows [b R / grid, (b + 1) R / grid) are non-empty, cover
    every row once and differ in length by at most one; the CTAs
    csrc/groupnorm.cu's cta_of names for a sample's first and last row bound
    the CTAs that hold it, no more than split_ctas_a_sample of them."""
    grid = groupnorm.split_grid(n, s, c, itemsize, ctas_per_sm, SMS)
    rows = n * s
    rows_a_pass = groupnorm.THREADS // (c * itemsize // 16)
    assert 1 <= grid <= min(ctas_per_sm * SMS, -(-rows // rows_a_pass))
    cuts = [b * rows // grid for b in range(grid + 1)]
    sizes = [cuts[b + 1] - cuts[b] for b in range(grid)]
    assert cuts[0] == 0 and cuts[-1] == rows and min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    cta_of = lambda r: ((r + 1) * grid - 1) // rows
    mmax = groupnorm.split_ctas_a_sample(n, s, grid)
    for smp in range(n):
        holders = [b for b in range(grid) if cuts[b] < (smp + 1) * s and cuts[b + 1] > smp * s]
        assert holders == list(range(cta_of(smp * s), cta_of(smp * s + s - 1) + 1))
        assert len(holders) <= mmax


def test_split_schedule_at_the_level_0_shape():
    """The (2, 4)-local level 0 at two CTAs an SM: one wave of 264 CTAs, 122
    or 123 rows each, where (38, 14) CTAs of 61 rows took three waves."""
    assert groupnorm.split_grid(14, 72 * 32, 320, 2, 2, SMS) == 264
    assert groupnorm.split_ctas_a_sample(14, 72 * 32, 264) == 20
