"""The shape arithmetic of K1r's two paths and of K3's launches, on the
CPU: ``ops.admm_iter.refined_plan`` (which path and cluster size a K1r
call takes on the card), ``refined_bytes`` (one CTA's shared memory on
the resident path, against a count by hand) and
``ops.term_products.launches_per_call``.  Nothing here needs a card:
the plan is decided from shapes before any launch.
"""

import pytest
import torch

from osqp_tpu_torch import _build
from osqp_tpu_torch.ops import admm_iter as k1
from osqp_tpu_torch.ops import term_products as k3

SMS = 132  # an H100 SXM's SMs

# (B, n, m, dtype, plan): the headline batch (bench.py) in both dtypes,
# the MPC cell (bench.py:bench_mpc, 1000 scenarios, n=372, m=612),
# CVXQP2_M at B=1 (one instance must fill the card), n=3000 (no cluster
# holds it), and batches below the SM count.
PLANS = [
    (8192, 100, 200, torch.float32, ("resident", 1)),
    (8192, 100, 200, torch.float64, ("resident", 2)),
    (512, 100, 200, torch.float64, ("resident", 2)),
    (1000, 372, 612, torch.float32, ("resident", 8)),
    (1000, 372, 612, torch.float64, ("resident", 16)),
    (1, 1000, 1250, torch.float32, ("split", 0)),
    (1, 1000, 1250, torch.float64, ("split", 0)),
    (1, 3000, 3000, torch.float32, ("split", 0)),
    (1, 2, 6000, torch.float64, ("split", 0)),
    (64, 100, 200, torch.float32, ("split", 0)),
    (SMS - 1, 100, 200, torch.float32, ("split", 0)),
    (SMS, 100, 200, torch.float32, ("resident", 1)),
    (66, 100, 200, torch.float64, ("resident", 2)),
    (8192, 513, 10, torch.float32, ("split", 0)),
]


@pytest.mark.parametrize("B,n,m,dtype,plan", PLANS)
def test_refined_plan(B, n, m, dtype, plan):
    assert k1.refined_plan(B, n, m, dtype, SMS) == plan


def _hand_count(n, m, k, elt, with_p):
    """One CTA's shared memory on the resident path, region by region."""
    r16 = lambda b: -(-b // 16) * 16
    rn, rm = -(-n // k), -(-m // k)
    pad = 16 // elt
    total = 16  # two mbarriers
    total += r16(elt * (rn * n + 2 * pad))  # Minv's slab and its copy's slack
    total += r16(elt * (rm * n + 2 * pad))  # A's
    total += r16(elt * (rn * n + 2 * pad)) if with_p else 0  # P's
    total += r16(elt * n)  # x~
    total += 3 * r16(elt * rn)  # t, r, x
    total += 9 * r16(elt * rm)  # w, z~, rho, z, y, rho^-1, l, u, y_lo
    total += 2 * r16(8 * rn)  # in double: P x~, A'(rho A x~)
    total += r16(8 * (16 if n <= 256 else 8) * n)  # the warps' column sums: 16 warps to n = 256, 8 above
    total += r16(8 * 2 * n) if k > 1 else 0  # the cluster's partials, double-buffered
    return total


@pytest.mark.parametrize("n,m,k,dtype,with_p,expect", [
    (100, 200, 1, torch.float32, True, 183312),
    (100, 200, 1, torch.float32, False, 143280),
    (100, 200, 2, torch.float64, True, 184512),
    (372, 612, 8, torch.float32, False, 220064),
    (372, 612, 16, torch.float32, True, 162928),
    (37, 53, 4, torch.float32, True, None),
    (33, 0, 2, torch.float64, False, None),
])
def test_refined_bytes_against_a_hand_count(n, m, k, dtype, with_p, expect):
    elt = 4 if dtype == torch.float32 else 8
    got = k1.refined_bytes(n, m, k, dtype, with_p)
    assert got == _hand_count(n, m, k, elt, with_p)
    if expect is not None:
        assert got == expect


def test_resident_plan_fits_and_never_exceeds_16():
    """Over a sweep of shapes and batch sizes, a resident plan names one
    of 1, 2, 4, 8, 16 whose share of Minv and A fits a CTA, the smallest
    such; P is resident exactly where it fits too."""
    seen = set()
    for dtype in (torch.float32, torch.float64):
        for n in (1, 7, 32, 100, 129, 256, 372, 500, 512):
            for m in (0, 1, 53, 200, 612, 1500, 4000):
                for B in (1, SMS // 4, SMS, 8192):
                    kind, k = k1.refined_plan(B, n, m, dtype, SMS)
                    if kind == "split":
                        assert k == 0
                        continue
                    seen.add(k)
                    assert k in k1.CLUSTERS and k <= 16 and B * k >= SMS
                    assert k1.refined_bytes(n, m, k, dtype, False) <= _build.SMEM_BYTES
                    smaller = [c for c in k1.CLUSTERS if c < k]
                    assert all(k1.refined_bytes(n, m, c, dtype, False) > _build.SMEM_BYTES for c in smaller)
                    assert k1.p_resident(n, m, k, dtype) == (k1.refined_bytes(n, m, k, dtype, True)
                                                             <= _build.SMEM_BYTES)
    assert seen == set(k1.CLUSTERS)


def test_p_resident_at_the_cells():
    assert k1.p_resident(100, 200, 1, torch.float32)
    assert k1.p_resident(100, 200, 2, torch.float64)
    assert not k1.p_resident(372, 612, 8, torch.float32)
    assert k1.p_resident(372, 612, 16, torch.float32)


def test_refined_on_cpu_tensors_takes_the_plain_version():
    """A CPU call neither plans nor counts a launch."""
    g = torch.Generator().manual_seed(0)
    B, n, m = 3, 4, 5
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    M = r(B, n, n)
    Minv = M @ M.mT + torch.eye(n)
    args = (Minv, r(B, m, n), Minv.clone(), r(B, n), r(B, m) - 2, r(B, m) + 2, r(B, m).abs() + 0.1,
            r(B, m).abs() + 0.1, 1e-6, 1.6, torch.ones(B, dtype=torch.bool), r(B, n), r(B, m), r(B, m),
            r(B, n), r(B, m))
    before = (k1.refined_launches, k1.refined_launches_resident)
    out = k1.admm_iter_refined(*args)
    assert (k1.refined_launches, k1.refined_launches_resident) == before
    want = k1.admm_iter_refined_plain(*args)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("B,n,m", [(8192, 100, 200), (1, 1000, 1250), (1000, 372, 612), (1, 600, 0), (7, 300, 900)])
@pytest.mark.parametrize("cert", [False, True])
def test_term_products_is_one_launch(B, n, m, cert):
    assert k3.launches_per_call(B, n, m, cert) == 1


def test_term_products_launches_nothing_for_an_empty_batch():
    assert k3.launches_per_call(0, 100, 200, True) == 0
