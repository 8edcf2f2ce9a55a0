"""The grouping kernel's path choice (``kernels.group_leaders_plan``) on the
CPU: which path, how many CTAs a cluster and how much shared memory at each
N, pinned, and the sizes it refuses.  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from groomed_nms_torch.ops import kernels

LIMIT = kernels._GROUP_CLUSTER_MAX_N


@pytest.mark.parametrize("n,want", [
    (1, ("cluster", 1, 804)),
    (64, ("cluster", 1, 1056)),
    (65, ("cluster", 2, 1596)),
    (128, ("cluster", 2, 1848)),
    (512, ("cluster", 8, 6600)),
    (576, ("cluster", 9, 7392)),
    (1000, ("cluster", 16, 12840)),
    (LIMIT - 1, ("cluster", 16, 12932)),
    (LIMIT, ("cluster", 16, 12936)),
    (LIMIT + 1, ("two_kernel", 0, 8608)),
    (2048, ("two_kernel", 0, 17152)),
    (4096, ("two_kernel", 0, 34304)),
    (kernels._GROUP_MAX_N, ("two_kernel", 0, 68608)),
])
def test_group_leaders_plan_is_pinned(n, want):
    """Up to the limit (1024 rows, 16 row blocks of 64) one cluster an
    image of one CTA a row block, in the default 48 KB of shared memory;
    above it the bits + sweep kernels."""
    assert LIMIT == 1024
    plan = kernels.group_leaders_plan(n)
    assert tuple(plan) == want
    assert plan.path == ("cluster" if n <= LIMIT else "two_kernel")
    if plan.path == "cluster":
        assert plan.ctas == -(-n // 64) <= kernels._GROUP_CLUSTER_CTAS
        assert plan.smem <= 48 * 1024


@pytest.mark.parametrize("n", [kernels._GROUP_MAX_N + 1, 20000])
def test_group_leaders_plan_refuses_above_the_kernel_limit(n):
    with pytest.raises(ValueError, match="N <="):
        kernels.group_leaders_plan(n)


def test_group_leaders_on_cpu_counts_no_path():
    """On CPU tensors the wrapper runs the plain version: no launch count
    and no path count moves."""
    rs = np.random.default_rng(3)
    m = torch.from_numpy(rs.uniform(0, 1, (2, 70, 70)).astype(np.float32))
    valid = torch.from_numpy(rs.uniform(size=(2, 70)) > 0.2)
    counts = (kernels.group_leaders.launches,
              kernels.group_leaders.cluster_launches,
              kernels.group_leaders.two_kernel_launches)
    got = kernels.group_leaders(m, valid, nms_threshold=0.4, group_size=2)
    assert torch.equal(got, kernels.group_leaders_plain(
        m, valid, nms_threshold=0.4, group_size=2))
    assert (kernels.group_leaders.launches,
            kernels.group_leaders.cluster_launches,
            kernels.group_leaders.two_kernel_launches) == counts
