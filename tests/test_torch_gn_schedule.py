"""The launch schedule of kernel A (ops/groupnorm.schedule): one cooperative
launch of at most two CTAs an SM, split into teams that each own one
sample at a time, as many teams as samples that the grid's shared memory
holds at once. Values for an H100 (132 SMs) at the shapes of the main
paths; then the rules on a sweep of shapes. CPU only, no JAX."""

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
