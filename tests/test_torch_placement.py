"""The batched kernel's launch plan (fused_do.launch_plan): which working
fields a block keeps in shared memory, how many bytes that takes, how
many blocks an SM it leaves room for, and the forward mode's tangent
groups. Plain Python, decided from sizes before a launch, so it runs here
without a card; tests/test_torch_cuda.py holds every placement and both G
against the plain version on the card.
"""

import contextlib
import re
import types

import pytest
import torch

from heston_tpu_torch.kernels import cuda_build, fused_do

# (name, options, ns, nv, scheme, american, tangents): the flagship book,
# its 5000-option tiling, lm60's trial pricing and its Jacobian launch
# (K = 4 and 5), the flagship book under Craig-Sneyd, lm60's Jacobian
# under Craig-Sneyd, the ladder calibration's Jacobian (200 options), and
# the reference's golden grid (101 x 76) as a book and in forward mode
SHAPES = [
    ("flagship", 500, 51, 26, "do", True, 0),
    ("b5000", 5000, 51, 26, "do", True, 0),
    ("lm60_prices", 60, 51, 26, "do", False, 0),
    ("lm60_k4", 60, 51, 26, "do", False, 4),
    ("lm60_k4_amer", 60, 51, 26, "do", True, 4),
    ("lm60_k5", 60, 51, 26, "do", False, 5),
    ("cs_book", 500, 51, 26, "cs", True, 0),
    ("cs_lm60_k4", 60, 51, 26, "cs", True, 4),
    ("lm_multi200_k4", 200, 51, 26, "do", True, 4),
    ("golden_book", 500, 101, 76, "do", True, 0),
    ("golden_k4", 5, 101, 76, "do", True, 4),
]
ITEMSIZE = {"f32": 4, "f64": 8}


def _plan(shape, dtype, **kw):
    _, b, ns, nv, scheme, american, k = shape
    return fused_do.launch_plan(b, ns, nv, ITEMSIZE[dtype], scheme,
                                american, k, **kw)


def _rows_bytes(shape, dtype, plan):
    """The shared rows a block takes, counted from the kernel's enums:
    11 s-rows and the floor, 9 v-rows and 5 penta factor rows, per tangent
    of the block one s-row and 8 v-rows; two int32 b1 nodes per v-column."""
    _, _, ns, nv, _, _, k = shape
    kg = k // plan.groups if k else 0
    return (ITEMSIZE[dtype] * (12 * ns + 14 * nv + kg * (ns + 8 * nv))
            + 8 * nv)


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_fields_placed_in_order_within_the_block_limit(shape, dtype):
    """The fields in shared memory are a prefix of the launch's fields in
    FIELDS order (the sweeps' operands first), their bytes and the rows'
    are what the plan says and at most the 232,448 bytes a block may opt
    into, and the scratch holds every other field."""
    _, b, ns, nv, scheme, american, k = shape
    plan = _plan(shape, dtype)
    kg = k // plan.groups if k else 0
    counts = fused_do.field_counts(scheme, american, kg)
    names = list(counts)
    assert names == [f for f in fused_do.FIELDS if f in counts]
    assert list(plan.smem_fields) == names[:len(plan.smem_fields)]
    surface = fused_do.surface_elems(ns, nv)
    in_smem = sum(counts[f] for f in plan.smem_fields)
    assert plan.smem_bytes == (_rows_bytes(shape, dtype, plan)
                               + ITEMSIZE[dtype] * in_smem * surface)
    assert plan.smem_bytes <= fused_do.SMEM_PER_BLOCK
    assert plan.scratch_elems == (sum(counts.values()) - in_smem) * surface
    assert plan.fmask == sum(1 << fused_do.FIELDS.index(f)
                             for f in plan.smem_fields)
    # the budget the default plan keeps: the next field would not fit
    rest = names[len(plan.smem_fields):]
    if rest:
        budget = fused_do.default_smem_budget(b, k, plan.groups)
        assert (plan.smem_bytes + ITEMSIZE[dtype] * counts[rest[0]] * surface
                > budget)


def test_field_order_matches_the_kernel():
    """FIELDS is the kernel's Field enum, in its order (csrc/fused_do.cu):
    the bit of a field in the launch's fmask is its index in both."""
    src = fused_do.SOURCE.read_text()
    body = re.search(r"enum Field \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",")
             if n.strip()]
    assert names[-1] == "NFIELD"
    assert [n[1:].lower() for n in names[:-1]] == list(fused_do.FIELDS)
    assert fused_do.FIELDS[:6] == ("d", "tw", "ti", "e", "tbuf", "trb")


@pytest.mark.parametrize("scheme,blocks", [("do", 4), ("cs", 4)])
def test_f32_primal_keeps_its_blocks_an_sm(scheme, blocks):
    """The float32 primal book at 51 x 26 keeps room for at least 4
    resident blocks an SM (500 options in one wave on 132 SMs) with every
    field in shared memory."""
    shape = ("book", 500, 51, 26, scheme, True, 0)
    plan = _plan(shape, "f32")
    assert plan.smem_fields == tuple(fused_do.field_counts(scheme, True))
    per_sm = fused_do.SMEM_PER_SM // (plan.smem_bytes
                                      + fused_do.SMEM_RESERVED)
    assert per_sm >= blocks
    assert 500 <= per_sm * fused_do.N_SM
    assert plan.threads == fused_do.PRIMAL_THREADS and plan.groups == 1


@pytest.mark.parametrize("b,scheme,threads", [
    (60, "do", 256), (264, "do", 256), (265, "do", 128), (60, "cs", 128)])
def test_small_douglas_books_take_wide_blocks(b, scheme, threads):
    """A Douglas primal book of at most two blocks an SM takes 256-thread
    blocks (its point-parallel phases in half the passes); a corrector's
    primal keeps 128 (its kernel's launch bounds)."""
    assert fused_do.launch_plan(b, 51, 26, 4, scheme, False).threads == (
        threads)


@pytest.mark.parametrize("dtype", sorted(ITEMSIZE))
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_zero_budget_keeps_every_field_global(shape, dtype):
    """smem_budget=0: no field in shared memory, only the rows."""
    _, b, ns, nv, scheme, american, k = shape
    plan = _plan(shape, dtype, smem_budget=0)
    kg = k // plan.groups if k else 0
    counts = fused_do.field_counts(scheme, american, kg)
    assert plan.smem_fields == () and plan.fmask == 0
    assert plan.smem_bytes == _rows_bytes(shape, dtype, plan)
    assert plan.scratch_elems == (sum(counts.values())
                                  * fused_do.surface_elems(ns, nv))


@pytest.mark.parametrize("k,threads", [(4, 256), (5, 128)])
def test_lm60_tangents_spread_over_more_than_60_sms(k, threads):
    """lm60's Jacobian launch (60 options): one block per option and
    tangent (G = K; 256 threads while two blocks an SM hold them all),
    all of them resident in one wave on 132 SMs with the shared memory
    each takes, so more than 60 SMs work."""
    plan = fused_do.launch_plan(60, 51, 26, 4, "do", False, k)
    assert plan.groups == k and plan.threads == threads
    blocks = 60 * plan.groups
    per_sm = fused_do.SMEM_PER_SM // (plan.smem_bytes
                                      + fused_do.SMEM_RESERVED)
    assert blocks > 60 and blocks <= per_sm * fused_do.N_SM
    assert min(blocks, fused_do.N_SM) > 60


def test_many_options_keep_all_tangents_in_a_block():
    """Past one wave of group blocks (lm_multi200: 800 > 3 x 132) every
    block carries all K tangents (G = 1, 256 threads) and may take an SM's
    shared memory; G divides K or ValueError."""
    assert fused_do.tangent_groups(200, 4) == 1
    plan = fused_do.launch_plan(200, 51, 26, 4, "do", True, 4)
    assert plan.groups == 1 and plan.threads == fused_do.WIDE_THREADS
    assert fused_do.default_smem_budget(200, 4, 1) == fused_do.SMEM_PER_BLOCK
    assert fused_do.launch_plan(60, 51, 26, 4, "do", True, 4,
                                groups=2).groups == 2
    for bad in (3, 0):
        with pytest.raises(ValueError):
            fused_do.launch_plan(60, 51, 26, 4, "do", True, 4, groups=bad)
    with pytest.raises(ValueError):
        fused_do.launch_plan(60, 51, 26, 4, "do", True, 0, groups=2)


# (dtype, scheme, options, tangents, threads, bounded): the kernel a launch
# takes (fused_do.bounded_kernel, as csrc/fused_do.cu's kernel_for
# chooses): float64 Douglas's primal at 128 threads (the book cell's 5,000
# options) is bounded to 4 blocks an SM and at 256 (264 options) is not;
# float32 Douglas is not at either; a corrector's primal loop (128 threads
# at any size) always is; the forward mode never
SELECTIONS = [
    (torch.float64, "do", 5000, 0, 128, True),
    (torch.float64, "do", 265, 0, 128, True),
    (torch.float64, "do", 264, 0, 256, False),
    (torch.float32, "do", 5000, 0, 128, False),
    (torch.float32, "do", 264, 0, 256, False),
    (torch.float64, "cs", 5000, 0, 128, True),
    (torch.float64, "hv", 60, 0, 128, True),
    (torch.float32, "mcs", 500, 0, 128, True),
    (torch.float32, "cs", 60, 0, 128, True),
    (torch.float64, "do", 200, 4, 256, False),
    (torch.float64, "do", 60, 4, 256, False),
    (torch.float64, "cs", 60, 5, 128, False),
]


@pytest.mark.parametrize("dtype,scheme,b,k,threads,bounded", SELECTIONS)
def test_bounded_kernel_by_dtype_threads_and_scheme(dtype, scheme, b, k,
                                                    threads, bounded):
    """Which launches take the kernel bounded to PRIMAL_BLOCKS_PER_SM
    blocks of PRIMAL_THREADS: chosen from the dtype, the scheme, the
    tangents and the threads the launch plan derives from the options."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = fused_do.launch_plan(b, 51, 26, itemsize, scheme, True, k)
    assert plan.threads == threads
    assert fused_do.bounded_kernel(dtype, scheme, plan.threads, k) == bounded


def test_book_cell_plan_budgets_four_blocks():
    """The book cell's launch (5,000 float64 American options, 51 x 26):
    128 threads, d, tw and ti in shared memory within the 4-block budget
    (233,472 / 4 - 1,024 bytes), u, comp and lam in global scratch; four
    such blocks fit an SM's shared memory, so the bound of 4 blocks an SM
    is the one the placement assumed."""
    plan = fused_do.launch_plan(5000, 51, 26, 8, "do", True)
    assert plan.threads == fused_do.PRIMAL_THREADS
    assert plan.smem_fields == ("d", "tw", "ti")
    assert fused_do.default_smem_budget(5000, 0, 1) == 57_344
    assert plan.smem_bytes <= 57_344
    assert fused_do.PRIMAL_BLOCKS_PER_SM * (
        plan.smem_bytes + fused_do.SMEM_RESERVED) <= fused_do.SMEM_PER_SM
    assert fused_do.bounded_kernel(torch.float64, "do", plan.threads)


@pytest.fixture
def fake_card(monkeypatch):
    """Kernel 1's launch path on CPU tensors against a stand-in library:
    the launch returns 0, the occupancy query reports 4 blocks an SM and
    records its arguments. The cache of resident_blocks is emptied
    before and after."""
    queries = []

    def occupancy(*args):
        queries.append(args[:12])
        args[12]._obj.value = 4
        args[13]._obj.value = 128
        args[14]._obj.value = 0
        return 0

    lib = types.SimpleNamespace(fused_do_f32=lambda *a: 0,
                                fused_do_f64=lambda *a: 0,
                                fused_do_occupancy=occupancy)
    monkeypatch.setattr(fused_do, "_library", lambda fmad=False: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    fused_do.resident_blocks.cache_clear()
    yield queries
    fused_do.resident_blocks.cache_clear()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_primal_launch_adds_its_blocks_an_sm_once_a_launch(fake_card,
                                                           dtype):
    """Every primal launch adds the resident blocks an SM of its kernel to
    fused_do_loop.resident_blocks; the occupancy query runs once for the
    shape (resident_blocks.queries counts it), with the launch's dtype,
    threads and placement, and a second launch of the same shape queries
    nothing."""
    b, ns, nv = 300, 11, 9
    plan = fused_do.launch_plan(b, ns, nv, 8 if dtype == torch.float64
                                else 4, "do", True)
    bufs = (torch.zeros(b, ns, nv, dtype=dtype),
            torch.zeros(b, ns, nv, dtype=dtype),
            torch.zeros(b, 11, ns, dtype=dtype),
            torch.zeros(b, 9, nv, dtype=dtype),
            torch.zeros(b, 2, dtype=dtype),
            torch.zeros(0, dtype=torch.int32),
            torch.zeros(b, 0, 2, ns, dtype=torch.int32),
            torch.zeros(b, 0, 2, ns, dtype=dtype))
    counters = (fused_do.fused_do_loop, "launches"), (
        fused_do.fused_do_loop, "resident_blocks"), (
        fused_do.resident_blocks, "queries")
    before = [getattr(o, a) for o, a in counters]
    for launch in (1, 2):
        fused_do._launch_packed(*bufs, theta=0.8, delta_t=0.05, n_steps=4,
                                rf=0.0, american=True, plan=plan)
        assert [getattr(o, a) - v for (o, a), v in zip(counters, before)
                ] == [launch, 4 * launch, 1]
    (query,) = fake_card
    assert query[0] == int(dtype == torch.float64) and query[1] == 0
    assert query[2:4] == (ns, nv) and query[9:] == (1, plan.fmask,
                                                     plan.threads)


def test_surface_layout():
    """A surface's s-row stride is odd and leaves two border columns on
    each side; one border s-row above and below."""
    assert [fused_do.row_stride(nv) for nv in (9, 10, 26, 76, 141)] == [
        13, 15, 31, 81, 145]
    assert fused_do.surface_elems(51, 26) == 53 * 31


def test_builds_by_dtype_and_purpose():
    """float32 primal launches take the -fmad=true build, the float32
    forward mode and float64 the -fmad=false one; a named build wins."""
    assert cuda_build.use_fmad(torch.float32)
    assert not cuda_build.use_fmad(torch.float32, tangent=True)
    assert not cuda_build.use_fmad(torch.float64)
    assert not cuda_build.use_fmad(torch.float64, tangent=True)
    assert cuda_build.use_fmad(torch.float32, True, tangent=True)
    assert not cuda_build.use_fmad(torch.float32, False)
