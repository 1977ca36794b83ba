"""The single-option kernel's launch plan (fused_single.launch_plan): how
many blocks of a thread-block cluster share the option, how many v rows
each owns, how many threads it runs, which working fields sit in shared
memory and how many bytes that takes. Plain Python, decided from sizes
before a launch, so it runs here without a card and without JAX;
tests/test_torch_cuda.py holds forced plans against the plain version on
the card.
"""

import pytest
import torch

from heston_tpu_torch.config import GridSpec, SolverConfig
from heston_tpu_torch.kernels import fused_single

SCHEMES = ("do", "cs", "mcs", "hv")
ITEMSIZE = {"f32": 4, "f64": 8}
# the reference's golden grid, the bench's 50 x 25 grid, and the largest
# grid class the routing rule admits in float64
GRIDS = {"golden": (101, 76), "s50": (51, 26), "g121": (121, 101)}


def _bytes(ns, nv, itemsize, scheme, cluster, n_smem):
    """A block's shared bytes, counted from the kernel's layout: two
    mbarriers (16 bytes), 11 coefficient s-rows and the floor row, 9 v-rows and 5 penta factors a
    v row, the sweep's column buffer (C > 1: ceil(ns/C) columns of nv | 1
    values), then the first n_smem fields: the two ping-pong buffers, u,
    the compensation and the multiplier (R + 4 rows with halos when
    C > 1), a corrector's L u (R rows), HV's z2 (with halos), the PCR
    factors (R rows each)."""
    rows = -(-nv // cluster)
    halo = 2 if cluster > 1 else 0
    names = fused_single.fields(scheme, fused_single.pcr_levels(ns))
    sizes = [(rows + 2 * halo if f in ("b0", "b1", "u", "comp", "lam",
                                       "z2w") else rows) * ns
             for f in names]
    colbuf = -(-ns // cluster) * (nv | 1) if cluster > 1 else 0
    return 16 + itemsize * (12 * ns + 14 * nv + colbuf
                            + sum(sizes[:n_smem]))


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
@pytest.mark.parametrize("scheme", ["do", "hv"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("cluster16", [True, False],
                         ids=["cluster16", "portable"])
def test_plan_at_the_reference_grids(grid, scheme, dtype, cluster16):
    """The golden grid, 50 x 25 and 121 x 101: the largest cluster that
    leaves every block two rows (16 blocks, or 8 where a 16-block cluster
    cannot be scheduled) with every field in shared memory, but 121 x 101
    in float64 on 8 blocks, whose last PCR factors go to global scratch;
    the bytes are the kernel's layout's, within a block's 227 KB."""
    ns, nv = GRIDS[grid]
    itemsize = ITEMSIZE[dtype]
    plan = fused_single.launch_plan(ns, nv, itemsize, scheme,
                                    cluster16=cluster16)
    names = fused_single.fields(scheme, fused_single.pcr_levels(ns))
    assert plan.cluster == (16 if cluster16 else 8)
    assert plan.rows == -(-nv // plan.cluster) >= 2
    assert plan.threads == min(512, 32 * -(-plan.rows * ns // 32))
    whole = not (grid == "g121" and dtype == "f64" and not cluster16)
    if whole:
        assert plan.smem_fields == names and plan.scratch_elems == 0
    else:
        n = len(plan.smem_fields)
        assert fused_single.state_fields(scheme) < n < len(names)
        assert plan.smem_fields == names[:n]
        assert plan.scratch_elems == (plan.cluster * (len(names) - n)
                                      * plan.rows * ns)
    assert plan.smem_bytes == _bytes(ns, nv, itemsize, scheme,
                                     plan.cluster, len(plan.smem_fields))
    assert plan.smem_bytes <= fused_single.SMEM_LIMIT == 232448


def test_golden_grid_bytes():
    """The golden grid's plan as the card runs it: 16 blocks of 5 rows
    and 512 threads, 59,756 bytes a block in float32 and 119,496 in
    float64 (Douglas); the 8-block plan 10 rows, 102,004 / 203,992."""
    for itemsize, c16, c8 in ((4, 59756, 102004), (8, 119496, 203992)):
        plan = fused_single.launch_plan(101, 76, itemsize, "do")
        assert (plan.cluster, plan.rows, plan.threads) == (16, 5, 512)
        assert plan.smem_bytes == c16
        plan8 = fused_single.launch_plan(101, 76, itemsize, "do",
                                         cluster16=False)
        assert (plan8.cluster, plan8.rows) == (8, 10)
        assert plan8.smem_bytes == c8


def _admitted():
    """Grids the routing rule sends to kernel 2 (use_single), from the
    smallest to the largest, square and lopsided."""
    solver = SolverConfig(solver_engine="pallas")
    grids = []
    for m1 in (2, 3, 6, 12, 20, 50, 100, 120, 200, 400, 800, 1612):
        for m2 in (2, 3, 5, 9, 25, 75, 100, 140):
            if fused_single.use_single(GridSpec(m1=m1, m2=m2), solver, 1):
                grids.append((m1 + 1, m2 + 1))
    return grids


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_every_admitted_grid_gets_a_plan(scheme, dtype):
    """Every grid use_single admits gets a plan, with or without the
    16-block cluster: each block's bytes within 232,448 and as the
    kernel's layout counts them, at least 2 rows a block (C > 1), the
    fields in shared memory a prefix of fields(), the rest in global
    scratch, every block's share of it counted."""
    grids = _admitted()
    assert (13, 10) in grids and (121, 101) in grids and len(grids) > 40
    itemsize = ITEMSIZE[dtype]
    for ns, nv in grids:
        names = fused_single.fields(scheme, fused_single.pcr_levels(ns))
        for cluster16 in (True, False):
            plan = fused_single.launch_plan(ns, nv, itemsize, scheme,
                                            cluster16=cluster16)
            assert plan.cluster in fused_single.CLUSTERS
            assert cluster16 or plan.cluster <= 8
            assert plan.cluster == 1 or plan.rows >= 2
            assert plan.rows * plan.cluster >= nv
            n = len(plan.smem_fields)
            assert plan.smem_fields == names[:n]
            assert plan.smem_bytes <= fused_single.SMEM_LIMIT
            assert plan.smem_bytes == _bytes(ns, nv, itemsize, scheme,
                                             plan.cluster, n)
            halo = 2 if plan.cluster > 1 else 0
            rest = sum((plan.rows + 2 * halo if f in ("b0", "b1", "u",
                                                      "comp", "lam", "z2w")
                        else plan.rows) * ns for f in names[n:])
            assert plan.scratch_elems == plan.cluster * rest
            assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
def test_forced_plans(dtype):
    """The private keywords force a plan: a cluster size, and the PCR
    factors in global scratch (the fields before them in shared memory as
    far as they fit)."""
    itemsize = ITEMSIZE[dtype]
    state = fused_single.state_fields("mcs")
    for cluster in (1, 2, 8):
        plan = fused_single.launch_plan(101, 76, itemsize, "mcs",
                                        cluster=cluster, factors=False)
        assert plan.cluster == cluster
        assert len(plan.smem_fields) <= state
        assert not any(f.startswith(("alpha", "gamma", "binv"))
                       for f in plan.smem_fields)
        assert plan.smem_bytes == _bytes(101, 76, itemsize, "mcs", cluster,
                                         len(plan.smem_fields))
    one = fused_single.launch_plan(101, 76, itemsize, "do", cluster=1)
    # one block holds the buffers, the state and the first two factors in
    # float32, the buffers and u in float64 (7,676 values a field)
    assert len(one.smem_fields) == {4: 7, 8: 3}[itemsize]
    assert one.scratch_elems == (20 - len(one.smem_fields)) * 76 * 101
    two = fused_single.launch_plan(101, 76, itemsize, "do", cluster=2,
                                   factors=False)
    assert two.smem_fields == ("b0", "b1", "u", "comp", "lam")
    assert two.scratch_elems == 2 * 15 * 38 * 101


@pytest.mark.parametrize("forced", ["cluster3", "cluster16_rows1",
                                    "cluster_buffers", "rows", "scheme",
                                    "itemsize"])
def test_forced_plan_that_does_not_fit_raises(forced):
    """A cluster size outside CLUSTERS or one that leaves a block fewer
    than 2 rows, a cluster whose blocks cannot hold both ping-pong buffers
    in shared memory, rows that alone overflow a block, an unknown scheme
    or item size: ValueError."""
    ns, nv, itemsize, scheme, kw = 101, 76, 8, "do", {}
    if forced == "cluster3":
        kw = dict(cluster=3)
    elif forced == "cluster16_rows1":
        nv, kw = 10, dict(cluster=16)
    elif forced == "cluster_buffers":
        ns, nv, kw = 1613, 3, dict(cluster=2)
    elif forced == "rows":
        ns, nv = 12000, 3
    elif forced == "scheme":
        scheme = "pcr"
    else:
        itemsize = 2
    with pytest.raises(ValueError):
        fused_single.launch_plan(ns, nv, itemsize, scheme, **kw)


def test_fields_order():
    """The placement order: the buffers and the state, a corrector's L u,
    HV's z2, then alpha and gamma of each PCR level and 1/b."""
    assert fused_single.fields("do", 2) == (
        "b0", "b1", "u", "comp", "lam", "alpha0", "gamma0", "alpha1",
        "gamma1", "binv")
    assert fused_single.fields("cs", 7)[5] == "luw"
    assert fused_single.fields("hv", 7)[5:7] == ("luw", "z2w")
    for scheme, pre in (("do", 5), ("cs", 6), ("mcs", 6), ("hv", 7)):
        assert fused_single.state_fields(scheme) == pre
        assert len(fused_single.fields(scheme, 7)) == pre + 15


@pytest.mark.parametrize("cluster", [3, 16])
def test_launch_rejects_a_forced_cluster_that_does_not_fit(cluster):
    """A forced cluster is launch_plan's: one outside CLUSTERS (3), or one
    that leaves a block of the 9 v rows fewer than 2 rows (16), raises in
    the wrapper before it builds anything."""
    fields, phases, _ = fused_single.single_plan(
        GridSpec(m1=12, m2=8), SolverConfig(n_steps=4,
                                            solver_engine="pallas"),
        torch.tensor([100.0], dtype=torch.float64), 100.0, 1.5, 0.04, 0.3,
        -0.9, 0.04, 0.025, 0.0)
    (steps, remaps, kw), = phases
    with pytest.raises(ValueError, match=f"a cluster of {cluster} blocks"):
        fused_single._launch(fields, steps, remaps, **kw, cluster=cluster,
                             factors=False)
