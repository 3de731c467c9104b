"""The port's sparse slab and the plain version of its GEVM/HVP kernels
against the JAX package (CPU).

The same numpy inputs go to both packages. The plain pieces are held
against the JAX Pallas kernels run in interpret mode (lane by lane) and
against the JAX ``scatter`` family (vmapped) at the ``elementwise``
tolerance of tests/tolerances.py: interpret mode and the CPU scatter agree
with each other only to float tolerance, not bitwise. ``tree_row_sum`` is
the same adds in the same order, so it must match bitwise, and the slab
build is byte-equal with the shape ladder off.
"""

import ctypes
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import fused_sparse as jfs
from photon_ml_tpu.ops import losses as jlosses
from photon_ml_tpu_torch.ops import fused_sparse as tfs
from photon_ml_tpu_torch.ops import losses as tlosses
from photon_ml_tpu_torch.ops.features import DenseFeatures
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.ops.objective import GLMBatch, GLMObjective
from photon_ml_tpu_torch.types import TaskType
from tolerances import assert_allclose

LOSSES = ["logistic", "squared", "poisson", "smoothed_hinge"]


def _dense_stack(rng, e, m, d, max_nnz=6):
    """(E, M, D) stack with 0..max_nnz non-zeros per row (some rows empty)."""
    x = np.zeros((e, m, d), np.float32)
    nnz = rng.integers(0, max_nnz + 1, size=(e, m))
    for i in range(e):
        for r in range(m):
            cols = rng.choice(d, size=nnz[i, r], replace=False)
            x[i, r, cols] = rng.normal(size=nnz[i, r])
    return x


def _inputs(seed, loss_name, e=4, m=19, d=33):
    rng = np.random.default_rng(seed)
    x = _dense_stack(rng, e, m, d)
    if loss_name == "poisson":
        y = rng.poisson(1.5, size=(e, m)).astype(np.float32)
    elif loss_name == "squared":
        y = rng.normal(size=(e, m)).astype(np.float32)
    else:
        y = (rng.random((e, m)) < 0.5).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=(e, m)).astype(np.float32)
    off = rng.normal(scale=0.2, size=(e, m)).astype(np.float32)
    wt[:, -2:] = 0.0
    off[:, -2:] = 1e4  # padding rows whose loss overflows: masked to an exact 0
    w = (rng.normal(size=(e, d)) * 0.3).astype(np.float32)
    v = rng.normal(size=(e, d)).astype(np.float32)
    vshift = rng.normal(size=e).astype(np.float32)
    return x, y, wt, off, w, v, vshift


def _slabs(x, kernel, val_dtype=np.float32):
    j = jfs.build_sparse_slab(x, bucketer="off", kernel=kernel)
    jslab = jfs.SparseSlab(j.idx, j.val.astype(val_dtype), j.dim, kernel)
    tslab = tfs.build_sparse_slab(torch.from_numpy(x), kernel=kernel)
    if val_dtype != np.float32:
        tslab = tslab.astype(torch.bfloat16)
    return jslab, tslab


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_interpret_lanes(fn, jslab, *lane_args):
    """Run a lane-level JAX pallas function lane by lane (interpret mode)."""
    outs = []
    for i in range(jslab.idx.shape[0]):
        lane = jfs.SparseSlab(jslab.idx[i], jslab.val[i], jslab.dim, jslab.kernel)
        outs.append(fn(lane, *(jnp.asarray(a[i]) for a in lane_args)))
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(len(outs[0]))]


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_plain_gevm_matches_jax_pallas_interpret(loss_name, storage):
    x, y, wt, off, w, _, _ = _inputs(3 + len(loss_name), loss_name)
    val_dtype = jnp.bfloat16 if storage == "bf16" else np.float32
    jslab, tslab = _slabs(x, "pallas", val_dtype)
    jl, tl = getattr(jlosses, loss_name), getattr(tlosses, loss_name)
    want = _jax_interpret_lanes(
        lambda s, yy, ww, oo, wv: jfs.fused_value_grad_parts(jl, s, yy, ww, oo, wv, interpret=True),
        jslab, y, wt, off, w,
    )
    got = tfs.fused_value_grad_parts(tl, tslab, *_t(y, wt, off, w))
    assert [tuple(g.shape) for g in got] == [(4,), (4, 33), (4,)]
    for g, e in zip(got, want):
        assert g.dtype == torch.float32
        assert_allclose(g.numpy(), e, kind="elementwise")


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("loss_name", LOSSES)
def test_plain_hvp_matches_jax_pallas_interpret(loss_name, storage):
    x, y, wt, off, w, v, vshift = _inputs(5 + len(loss_name), loss_name)
    val_dtype = jnp.bfloat16 if storage == "bf16" else np.float32
    jslab, tslab = _slabs(x, "pallas", val_dtype)
    jl, tl = getattr(jlosses, loss_name), getattr(tlosses, loss_name)
    want = _jax_interpret_lanes(
        lambda s, yy, ww, oo, wv, vv, vs: jfs.fused_hvp_parts(jl, s, yy, ww, oo, wv, vv, vs,
                                                              interpret=True),
        jslab, y, wt, off, w, v, vshift,
    )
    got = tfs.fused_hvp_parts(tl, tslab, *_t(y, wt, off, w, v, vshift))
    assert [tuple(g.shape) for g in got] == [(4, 33), (4,)]
    for g, e in zip(got, want):
        assert_allclose(g.numpy(), e, kind="elementwise")


@pytest.mark.parametrize("loss_name", LOSSES)
def test_plain_parts_match_jax_scatter_family(loss_name):
    """The JAX generic slab path (scatter family), vmapped over lanes."""
    x, y, wt, off, w, v, vshift = _inputs(11 + len(loss_name), loss_name, e=6, m=32, d=64)
    jslab, tslab = _slabs(x, "scatter")
    jl, tl = getattr(jlosses, loss_name), getattr(tlosses, loss_name)

    def vg(s, yy, ww, oo, wv):
        z = s.matvec(wv) + oo
        wl = jnp.where(ww > 0, ww * jl.loss(z, yy), 0.0)
        d = jnp.where(ww > 0, ww * jl.d1(z, yy), 0.0)
        return jfs.tree_row_sum(wl), s.rmatvec(d), jfs.tree_row_sum(d)

    def hvp(s, yy, ww, oo, wv, vv, vs):
        z = s.matvec(wv) + oo
        c = jnp.where(ww > 0, ww * jl.d2(z, yy), 0.0) * (s.matvec(vv) + vs)
        return s.rmatvec(c), jfs.tree_row_sum(c)

    J = lambda *a: [jnp.asarray(b) for b in a]
    want_vg = jax.vmap(vg)(jslab, *J(y, wt, off, w))
    want_hvp = jax.vmap(hvp)(jslab, *J(y, wt, off, w, v, vshift))
    got_vg = tfs.fused_value_grad_parts(tl, tslab.with_kernel("scatter"), *_t(y, wt, off, w))
    got_hvp = tfs.fused_hvp_parts(tl, tslab, *_t(y, wt, off, w, v, vshift))
    for g, e in zip(list(got_vg) + list(got_hvp), list(want_vg) + list(want_hvp)):
        assert_allclose(g.numpy(), np.asarray(e), kind="elementwise")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 37, 64, 100])
def test_tree_row_sum_is_bitwise_the_jax_tree(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(5, n)) * 10.0 ** rng.integers(-3, 4, size=(5, n))).astype(np.float32)
    got = tfs.tree_row_sum(torch.from_numpy(x)).numpy()
    want = np.asarray(jfs.tree_row_sum(jnp.asarray(x)))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _kernel_loop_margins(w, idx, val):
    """csrc/fused_sparse.cu step 4 in numpy float32, one row at a time: tpr
    threads, thread t adding w[j] * x for q = t, t + tpr, ... from 0, then
    the adjacent-pair tree over the tpr partials (pair_tree)."""
    e, m, k = idx.shape
    tpr = tfs.row_threads_for(m, k)
    out = np.zeros((e, m), np.float32)
    for li in range(e):
        for r in range(m):
            parts = []
            for t in range(tpr):
                z = np.float32(0.0)
                for q in range(t, k, tpr):
                    z = np.float32(z + np.float32(w[li, idx[li, r, q]] * val[li, r, q]))
                parts.append(z)
            while len(parts) > 1:
                parts = [np.float32(parts[i] + parts[i + 1]) for i in range(0, len(parts), 2)]
            out[li, r] = parts[0]
    return out


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("e,m,d,max_nnz", [
    (3, 12, 9, 9),  # the GAME driver's slab shape: tpr 2, K odd
    (2, 37, 65, 1),  # K = 1
    (4, 5, 40, 33),  # K not a multiple of tpr
    (2, 3, 20, 7),
    (1, 64, 300, 64),
    (5, 16, 120, 24),
])
def test_plain_margin_is_bitwise_the_kernel_loop(e, m, d, max_nnz, storage):
    """SparseSlab.matvec adds its K products in the kernels' association,
    so the plain version and the kernel agree bitwise at any w."""
    rng = np.random.default_rng(e * 1000 + m + max_nnz)
    x = _dense_stack(rng, e, m, d, max_nnz=max_nnz)
    x[:, :, rng.integers(d)] = rng.normal(size=(e, m))  # rows at K exactly
    slab = tfs.build_sparse_slab(torch.from_numpy(x))
    if storage == "bf16":
        slab = slab.astype(torch.bfloat16)
    w = rng.normal(size=(e, d)).astype(np.float32)
    got = slab.matvec(torch.from_numpy(w)).numpy()
    val = slab.val.to(torch.float32).numpy()  # bf16 upcast, as Val<V>::f does
    want = _kernel_loop_margins(w, slab.idx.numpy(), val)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(tfs.SlabLanes(slab, torch.tensor([e - 1, 0], dtype=torch.int32))
                          .matvec(torch.from_numpy(w[[e - 1, 0]])).numpy(), got[[e - 1, 0]])


@pytest.mark.parametrize("shape,max_nnz", [((4, 19, 33), 6), ((3, 8, 5), 1), ((2, 7, 9), 9),
                                           ((5, 16), 4)])
def test_build_sparse_slab_is_byte_equal_to_jax(shape, max_nnz):
    rng = np.random.default_rng(sum(shape))
    if len(shape) == 3:
        x = _dense_stack(rng, *shape, max_nnz=max_nnz)
    else:
        x = _dense_stack(rng, 1, *shape, max_nnz=max_nnz)[0]
    x[0, 0] = 0.0  # an empty row
    want = jfs.build_sparse_slab(x, bucketer="off")
    got = tfs.build_sparse_slab(torch.from_numpy(x))
    assert got.dim == want.dim and got.kernel == want.kernel
    for g, e in ((got.idx, want.idx), (got.val, want.val)):
        g, e = g.numpy(), np.asarray(e)
        assert g.dtype == e.dtype and g.shape == e.shape
        assert g.tobytes() == e.tobytes()
    assert tfs.slab_nnz_stats(got) == jfs.slab_nnz_stats(want)
    assert torch.equal(got.to_dense().reshape(x.shape), torch.from_numpy(x))


def test_column_order_lists_each_columns_slots_in_flat_order():
    """The kernels' column tables: per lane, every populated column once,
    in ascending order, with its real slots in flat (m, k) order; no
    padding slot listed."""
    x, *_ = _inputs(1, "logistic", e=3, m=11, d=17)
    slab = tfs.build_sparse_slab(torch.from_numpy(x))
    t = slab.kernel_tables()
    e, m, k = slab.idx.shape
    assert t.lane_cols.dtype == t.cols.dtype == t.col_end.dtype == torch.int32
    assert t.slot16 and t.slots.dtype == torch.int16
    assert tuple(t.lane_cols.shape) == (e + 1,) and t.cols.shape == t.col_end.shape
    assert slab.kernel_tables() is t  # built once
    idx, val = slab.idx.reshape(e, -1), slab.val.reshape(e, -1)
    slots, col_end = t.slot_positions(), t.col_end.long()
    assert int(col_end[-1]) == int((val != 0).sum()) == slots.numel()
    for lane in range(e):
        entries = range(int(t.lane_cols[lane]), int(t.lane_cols[lane + 1]))
        cols = [int(t.cols[c]) for c in entries]
        assert cols == sorted(set(int(j) for j in idx[lane][val[lane] != 0]))
        for c in entries:
            s = slots[(int(col_end[c - 1]) if c else 0):int(col_end[c])]
            assert torch.all(idx[lane, s] == t.cols[c]) and torch.all(val[lane, s] != 0)
            assert torch.all(s[1:] > s[:-1])  # flat (m, k) order


def _column_pass(slab, rows):
    """The kernels' transpose over their tables in plain torch: per
    populated column, val * row value summed over its slots in table order
    (one add per rank, so the order is the kernel's), unpopulated columns 0."""
    t = slab.kernel_tables()
    e, m, k = slab.idx.shape
    counts = torch.diff(t.col_end.long(), prepend=torch.zeros(1, dtype=torch.long))
    start = t.col_end.long() - counts
    lane = torch.repeat_interleave(torch.arange(e), torch.diff(t.lane_cols.long()))
    q = t.slot_positions()
    prod = slab.val.reshape(-1)[lane.repeat_interleave(counts) * m * k + q].float() * \
        rows.reshape(-1)[lane.repeat_interleave(counts) * m + q // k]
    acc = torch.zeros(t.cols.numel())
    for r in range(int(counts.max()) if counts.numel() else 0):
        live = counts > r
        acc[live] = acc[live] + prod[start[live] + r]
    out = torch.zeros(e * slab.dim)
    out[lane * slab.dim + t.cols.long()] = acc
    return out.reshape(e, slab.dim)


@pytest.mark.parametrize("e,m,d,max_nnz,storage", [
    (4, 19, 33, 6, "f32"), (3, 11, 17, 6, "bf16"), (5, 1, 9, 4, "f32"), (6, 8, 1, 1, "f32"),
    (2, 9000, 12, 8, "f32")])
def test_column_pass_over_the_tables_is_bitwise_rmatvec(e, m, d, max_nnz, storage):
    """The kernels' column order is the plain transpose's flat order: a
    column pass over the tables equals slab.rmatvec bit for bit. The last
    case has M * K above 65536 slots: 32-bit slot positions."""
    rng = np.random.default_rng(e * m + d)
    x = _dense_stack(rng, e, m, d, max_nnz=max_nnz)
    slab = tfs.build_sparse_slab(torch.from_numpy(x))
    if storage == "bf16":
        slab = slab.astype(torch.bfloat16)
    assert slab.kernel_tables().slot16 == (m * slab.max_nnz <= 65536)
    rows = torch.from_numpy(rng.normal(size=(e, m)).astype(np.float32))
    assert torch.equal(_column_pass(slab, rows), slab.rmatvec(rows))


def test_column_tables_scale_with_the_non_zeros_not_d():
    rng = np.random.default_rng(7)
    small = _dense_stack(rng, 8, 16, 64, max_nnz=4)
    wide = np.zeros((8, 16, 4096), np.float32)
    wide[..., :64] = small  # the same non-zeros in a 64x wider space
    tables = [tfs.build_sparse_slab(torch.from_numpy(a)).kernel_tables() for a in (small, wide)]
    assert tables[0].nbytes == tables[1].nbytes
    nnz = int((small != 0).sum())
    cols = tables[0].cols.numel()
    assert tables[0].nbytes == 2 * 4 * (8 + 1) + 8 * cols + 2 * nnz
    # a dense column index (col_start over D + 1 columns) takes 4 (D + 1) bytes a lane
    assert tables[1].nbytes < 4 * 8 * (4096 + 1) / 10


@pytest.mark.parametrize("kind", ["gevm", "hvp"])
@pytest.mark.parametrize("shape", [
    (1024, 64, 16, 2048), (20000, 12, 9, 9), (1000, 1, 16, 2048), (1000, 64, 1, 2048),
    (1000, 64, 16, 1), (256, 12, 9, 4096), (1024, 64, 16, 4096), (1, 64, 16, 2048),
    (4, 40000, 4, 64)])
@pytest.mark.parametrize("val_bytes", [4, 2])
def test_launch_plan_covers_every_lane_within_shared_memory(shape, kind, val_bytes):
    e, m, k, d = shape
    hvp = kind == "hvp"
    plan = tfs.plan_launch(e, m, k, d, val_bytes, hvp)
    lanes = plan.lanes_per_block
    assert lanes >= 1 and plan.blocks * lanes >= e > (plan.blocks - 1) * lanes
    assert plan.threads % plan.row_threads == 0 and plan.row_threads <= 32
    # threads per row: a power of two, no more than K needs, and the rows
    # of a block of the shape's own packing (SLOTS_PER_BLOCK, whatever E
    # is) fill at most its threads
    tpr = plan.row_threads
    assert tpr & (tpr - 1) == 0 and (tpr == 1 or tpr < 2 * k)
    base = -(-tfs.SLOTS_PER_BLOCK // (m * k))
    assert tpr == 1 or tpr * base * m <= plan.threads < 2 * tpr * base * m or tpr in (32, k)
    assert tpr == tfs.row_threads_for(m, k)
    assert plan.rows_pow2 >= m > plan.rows_pow2 // 2 or plan.rows_pow2 == m == 1
    assert plan.smem_bytes <= tfs.SMEM_BUDGET <= tfs.SMEM_LIMIT
    # by default the tables are staged at what the shape allows
    assert (plan.table_cols, plan.table_slots) == (lanes * min(m * k, d), lanes * m * k)
    # the layout of csrc/fused_sparse.cu, region by region
    a16 = lambda n: (n + 15) // 16 * 16
    staged = lambda n: a16(n) + 16
    slots = lanes * m * k
    want = (a16(8 * (lanes + 1))
            + plan.staged * (a16(8 * lanes * plan.rows_pow2) + 3 * staged(4 * lanes * m)
                             + staged(4 * slots) + staged(val_bytes * slots)
                             + 2 * staged(4 * plan.table_cols)
                             + staged((2 if m * k <= 65536 else 4) * plan.table_slots))
            + plan.stage_coef * (2 if hvp else 1) * staged(4 * lanes * d))
    assert plan.smem_bytes == want
    assert plan.scratch_floats == (0 if plan.staged
                                   else plan.blocks * 2 * lanes * plan.rows_pow2)
    if lanes > 1:
        assert plan.staged  # a block packs lanes only while their data is small
    if (m, k, d) == (12, 9, 4096):
        assert lanes > 1 and not plan.stage_coef  # w (and v) through __ldg
    if shape == (1024, 64, 16, 2048):
        assert lanes == 1 and plan.staged and plan.stage_coef
    if shape == (20000, 12, 9, 9):
        # more lanes a block than the slots ask for, so that the grid is one
        # wave of eight blocks on each of 132 SMs; on twice the SMs the slots
        # rule
        assert lanes * m * k > tfs.SLOTS_PER_BLOCK and plan.staged and plan.stage_coef
        assert plan.blocks <= 132 * tfs.BLOCKS_PER_SM
        twice = tfs.plan_launch(e, m, k, d, val_bytes, hvp, sms=264)
        assert twice.lanes_per_block == -(-tfs.SLOTS_PER_BLOCK // (m * k)) < lanes
    if m == 40000:
        assert not plan.staged and plan.scratch_floats > 0


@pytest.mark.parametrize("shape", [(12, 9, 9), (64, 16, 2048), (1, 16, 2048), (37, 1, 65),
                                   (2048, 3, 64)])
@pytest.mark.parametrize("val_bytes", [4, 2])
def test_lane_arithmetic_does_not_depend_on_the_lane_count(shape, val_bytes):
    """What sets a lane's association (threads per row, rows padded to a
    power of two) is the same for every E from 1 to 20000, direct or
    lane-indirect: a compacted batch sums each lane as the full one does."""
    m, k, d = shape
    want = (tfs.row_threads_for(m, k), 1 << (m - 1).bit_length() if m > 1 else 1)
    for indirect in (False, True):
        got = {(p.row_threads, p.rows_pow2)
               for p in (tfs.plan_launch(e, m, k, d, val_bytes, hvp, indirect=indirect)
                         for e in range(1, 20001) for hvp in (False, True))}
        assert got == {want}


def test_launch_plan_stages_the_tables_a_slab_needs():
    """Given a slab's own per-lane maxima, the plan stages that much of the
    column tables, not what the shape allows."""
    wide = tfs.plan_launch(1024, 64, 16, 2048, 4, True)
    tight = tfs.plan_launch(1024, 64, 16, 2048, 4, True, lane_cols=330, lane_slots=400)
    assert (tight.table_cols, tight.table_slots) == (330, 400)
    assert tight.smem_bytes < wide.smem_bytes
    x, *_ = _inputs(1, "logistic", e=3, m=11, d=17)
    t = tfs.build_sparse_slab(torch.from_numpy(x)).kernel_tables()
    assert t.max_lane_cols == int(torch.diff(t.lane_cols).max())
    assert t.max_lane_slots == int(torch.diff(t.lane_slots).max()) <= 11 * 6


def test_slab_plan_struct_matches_the_c_layout():
    """ctypes lays out _SlabPlan as C does SlabPlan: seven pointers, a long
    long and thirteen ints."""
    assert ctypes.sizeof(tfs._SlabPlan) == 120
    assert tfs._SlabPlan.lanes.offset == 56 and tfs._SlabPlan.smem_bytes.offset == 112


def test_sparse_spec_grammar(monkeypatch):
    monkeypatch.delenv("PHOTON_SPARSE_KERNEL", raising=False)
    assert tfs.resolve_sparse_kernel(None) is None
    for off in ("off", "", "none", "0", "false"):
        assert tfs.resolve_sparse_kernel(off) is None
    for fam in ("scatter", "segment", "flat", "pallas", "pallas:256", "PALLAS"):
        assert tfs.resolve_sparse_kernel(fam) == fam.lower()
        assert tfs.resolve_sparse_kernel(fam) == jfs.resolve_sparse_kernel(fam)
    monkeypatch.setenv("PHOTON_SPARSE_KERNEL", "pallas")
    assert tfs.resolve_sparse_kernel(None) == "pallas"
    for race in ("auto", "on", "race"):
        assert tfs.resolve_sparse_kernel(race) == jfs.resolve_sparse_kernel(race) == "auto"
    for bad in ("bogus", "flat:128", "scatter:8"):
        with pytest.raises(ValueError, match="bad sparse-kernel spec"):
            tfs.resolve_sparse_kernel(bad)


def test_f64_slab_is_never_fused():
    x, y, wt, off, *_ = _inputs(2, "logistic")
    rows = tuple(torch.from_numpy(a) for a in (y, off, wt))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        slab = tfs.build_and_select(TaskType.LOGISTIC_REGRESSION,
                                    torch.from_numpy(x.astype(np.float64)), *rows, "pallas", "re")
    assert slab.kernel == "scatter" and any("float64" in str(w.message) for w in caught)
    assert tfs.build_and_select(TaskType.LOGISTIC_REGRESSION, torch.from_numpy(x), *rows,
                                "pallas:256", "re").kernel == "pallas:256"


@pytest.mark.parametrize("loss_name", LOSSES)
def test_objective_on_slab_lanes_matches_dense_lanes(loss_name):
    """value_and_grad and hessian_vector of lane-batched batches: the fused
    slab pieces, the plain slab path and the dense (E, M, D) stack agree."""
    x, y, wt, off, w, v, _ = _inputs(21 + len(loss_name), loss_name)
    obj = GLMObjective(getattr(tlosses, loss_name))
    norm = NormalizationContext.identity()
    yt, wtt, offt, wv, vv = _t(y, wt, off, w, v)
    slab = tfs.build_sparse_slab(torch.from_numpy(x))
    batches = [GLMBatch(DenseFeatures(torch.from_numpy(x)), yt, offt, wtt)] + [
        GLMBatch(slab.with_kernel(k), yt, offt, wtt) for k in ("scatter", "pallas")
    ]
    outs = [obj.value_and_grad(wv, b, norm, 0.3) + (obj.hessian_vector(wv, vv, b, norm, 0.3),)
            for b in batches]
    assert tuple(outs[0][0].shape) == (4,) and tuple(outs[0][1].shape) == (4, 33)
    for other in outs[1:]:
        for g, e in zip(other, outs[0]):
            assert_allclose(g.numpy(), e.numpy(), kind="elementwise")
    # slab families share one arithmetic on the CPU: bitwise equal
    for g, e in zip(outs[2], outs[1]):
        assert torch.equal(g, e)


def test_kernel_wrappers_refuse_cpu_slabs():
    x, y, wt, off, w, v, vshift = _inputs(4, "logistic")
    slab = tfs.build_sparse_slab(torch.from_numpy(x))
    with pytest.raises(ValueError, match="CUDA"):
        tfs.sparse_gevm_kernel(tlosses.logistic, slab, *_t(y, wt, off, w))
    with pytest.raises(ValueError, match="CUDA"):
        tfs.sparse_hvp_kernel(tlosses.logistic, slab, *_t(y, wt, off, w, v, vshift))


def test_slab_square_pieces_match_jax():
    x, y, *_ = _inputs(8, "logistic", e=3, m=9, d=13)
    jslab, tslab = _slabs(x, "scatter")
    want_norms = jax.vmap(lambda s: s.row_sq_norms())(jslab)
    want_sq = jax.vmap(lambda s, d: s.sq_rmatvec(d))(jslab, jnp.asarray(y))
    assert_allclose(tslab.row_sq_norms().numpy(), np.asarray(want_norms), kind="elementwise")
    assert_allclose(tslab.sq_rmatvec(torch.from_numpy(y)).numpy(), np.asarray(want_sq),
                    kind="elementwise")
