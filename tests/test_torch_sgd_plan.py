"""The SGD kernel's launch plan and update (`kernels.local_step.sgd_plan`,
``csrc/sgd_f32.cu``), on the CPU.

* (a) `sgd_plan`: every element of every non-empty leaf is updated
  exactly once by the blocks' slot ranges and their threads' slots
  (tid + 256·u, `SGD_UNROLL` at a time); a table holds at most
  `SGD_MAX_LEAVES` leaves and `SGD_MAX_VIEWS` gradient views; the paper
  CNN's 10 leaves are one launch whose grid fills the H100's 132 SMs,
  with leaf boundaries inside blocks' ranges; what the kernel takes no
  table for raises.
* (b) A plain emulation of the kernel in the plan's order — each slot's
  four elements read through the leaf's table entry, a gradient that is a
  view of up to 4 dims read through its sizes and strides as the kernel
  decodes them — held bit for bit to `ref.sgd_update_ref` and to the JAX
  package's `sgd_update_flat` (interpret mode) on the same numpy inputs.
* (c) `sgd_update_tree` on CPU leaves with permuted gradient views (as
  autograd hands the native CNN's conv weights) takes the plain version
  leaf by leaf, bit for bit; the kernel's wrapper refuses CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.local_step import sgd_update_flat
from repro_torch.kernels import local_step as TL
from repro_torch.kernels.ref import sgd_update_ref

torch.set_num_threads(2)

N_SMS = 132
LR, WD = 1e-2, 1e-4
CNN_SIZES = (1728, 64, 73728, 128, 294912, 256, 1048576, 256, 2560, 10)
CNN_VIEWS = (0, 2, 4)        # the conv weights' gradients
SETS = {
    "cnn": (CNN_SIZES, ()),
    "cnn_views": (CNN_SIZES, CNN_VIEWS),
    "ragged": ((1, 3, 65537, 10000, 0, 5), ()),
    "many": (tuple(5 + i for i in range(100)), ()),
    "many_views": (tuple(5 + i for i in range(30)), tuple(range(0, 30, 3))),
    "crossing": ((7, 1, 13, 2, 4, 999, 3, 5000, 6, 77, 1, 300), ()),
    "wide": ((3_000_000, 1), ()),
}


def _slots_of(plan):
    """Every slot the kernel's threads take, in the order of blocks,
    iterations, unroll steps and threads."""
    out = []
    for b in range(plan.grid):
        lo, hi = b * plan.per_block, min((b + 1) * plan.per_block,
                                         plan.slots)
        for base in range(lo, hi, TL.SGD_THREADS * TL.SGD_UNROLL):
            for u in range(TL.SGD_UNROLL):
                start = base + u * TL.SGD_THREADS
                out.extend(range(start, min(start + TL.SGD_THREADS, hi)))
    return out


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SETS))
def test_plan_updates_every_element_once(name):
    sizes, views = SETS[name]
    plans = TL.sgd_plan(sizes, views)
    seen = np.zeros(sum(sizes), np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    leaves = [i for plan in plans for i in plan.leaves]
    assert leaves == [i for i, n in enumerate(sizes) if n]
    for plan in plans:
        assert len(plan.leaves) <= TL.SGD_MAX_LEAVES
        assert sum(i in views for i in plan.leaves) <= TL.SGD_MAX_VIEWS
        counts = [-(-sizes[i] // TL.SGD_SLOT) for i in plan.leaves]
        assert plan.slot0 == tuple(np.cumsum([0] + counts[:-1]))
        assert plan.slots == sum(counts)
        assert plan.grid <= TL.SGD_BLOCKS
        assert (plan.grid - 1) * plan.per_block < plan.slots <= \
            plan.grid * plan.per_block
        slots = _slots_of(plan)
        assert sorted(slots) == list(range(plan.slots))
        leaf_of = np.searchsorted(plan.slot0, slots, side="right") - 1
        for s, j in zip(slots, leaf_of):
            i = plan.leaves[j]
            e = (s - plan.slot0[j]) * TL.SGD_SLOT
            hi = min(sizes[i], e + TL.SGD_SLOT)
            seen[offsets[i] + e:offsets[i] + hi] += 1
    assert np.all(seen == 1)


def test_plan_fills_the_card_with_one_launch_for_the_cnn():
    (plan,) = TL.sgd_plan(CNN_SIZES, CNN_VIEWS)
    assert plan.grid == TL.SGD_BLOCKS == 2 * N_SMS
    assert plan.per_block <= TL.SGD_THREADS * TL.SGD_UNROLL
    # ranges cross leaf boundaries: a block holds the start of a leaf
    inside = [s for s in plan.slot0
              if s % plan.per_block and s // plan.per_block < plan.grid]
    assert inside


def test_plan_tables_split_at_their_limits():
    assert len(TL.sgd_plan(tuple([4] * 100))) == 2
    assert [len(p.leaves) for p in TL.sgd_plan(tuple([4] * 129))] == \
        [64, 64, 1]
    views = TL.sgd_plan(tuple([4] * 20), tuple(range(20)))
    assert [len(p.leaves) for p in views] == [8, 8, 4]
    assert TL.sgd_plan((0, 0)) == ()


@pytest.mark.parametrize("sizes,views", [((-1, 4), ()), ((4, 4), (2,)),
                                         ((2 ** 31, 4), (0,))])
def test_plan_refuses_what_the_kernel_does_not_take(sizes, views):
    with pytest.raises(ValueError, match="sgd_plan"):
        TL.sgd_plan(sizes, views)


# ---------------------------------------------------------------------------
# (b) the update in the kernel's order
# ---------------------------------------------------------------------------

def _view_offset(sizes, strides, e):
    """csrc's view_offset: element e (row-major in p's shape) of a
    gradient view, its sizes and strides padded to 4 dims."""
    off = 0
    for d in (3, 2, 1):
        off += (e % sizes[d]) * strides[d]
        e //= sizes[d]
    return off + e * strides[0]


def _emulate(params, grads):
    """New leaves as the kernel computes them: slot by slot in the plan's
    order, each slot's gradient read through the leaf's contiguous memory
    or its view."""
    views = [TL._grad_view(g) for g in grads]
    outs = [torch.full_like(p, float("nan")) for p in params]
    plans = TL.sgd_plan(tuple(p.numel() for p in params),
                        tuple(i for i, v in enumerate(views) if v))
    for plan in plans:
        for s in _slots_of(plan):
            j = int(np.searchsorted(plan.slot0, s, side="right")) - 1
            i = plan.leaves[j]
            p, g, o = params[i].reshape(-1), grads[i], outs[i].reshape(-1)
            e = (s - plan.slot0[j]) * TL.SGD_SLOT
            el = torch.arange(e, min(p.numel(), e + TL.SGD_SLOT))
            if views[i] is None:
                gv = g.reshape(-1)[el]
            else:
                memory = torch.as_strided(g, (g.untyped_storage().nbytes()
                                              // 4,), (1,), 0)
                gv = memory[[g.storage_offset() +
                             _view_offset(*views[i], int(k)) for k in el]]
            o[el] = sgd_update_ref(p[el], gv, lr=LR, wd=WD)
    return outs


def _leaves(rng, sizes):
    return [torch.from_numpy(rng.normal(size=n).astype(np.float32))
            for n in sizes]


@pytest.mark.parametrize("name", ["ragged", "many", "crossing"])
def test_emulated_update_bitwise_to_plain_and_pallas(name):
    rng = np.random.default_rng(len(name))
    sizes, _ = SETS[name]
    params, grads = _leaves(rng, sizes), _leaves(rng, sizes)
    got = _emulate(params, grads)
    for o, p, g in zip(got, params, grads):
        assert torch.equal(o, sgd_update_ref(p, g, lr=LR, wd=WD))
    flat = [np.concatenate([t.numpy().ravel() for t in ts])
            for ts in (params, grads)]
    want = np.asarray(sgd_update_flat(jnp.asarray(flat[0]),
                                      jnp.asarray(flat[1]), lr=LR, wd=WD,
                                      interpret=True))
    assert np.array_equal(np.concatenate([o.numpy().ravel() for o in got]),
                          want)


def test_emulated_update_reads_gradient_views_in_place():
    """The CNN's conv weight shapes (width 8) with each gradient a
    permuted view of an OIHW tensor, beside contiguous leaves: the
    kernel's decoding of the view gives the plain version's update."""
    rng = np.random.default_rng(3)
    shapes = [(3, 3, 3, 8), (8,), (3, 3, 8, 16), (16,), (64, 10)]
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in shapes]
    grads = [torch.from_numpy(rng.normal(size=s[::-1]).astype(np.float32))
             .permute(3, 2, 1, 0) if len(s) == 4 else
             torch.from_numpy(rng.normal(size=s).astype(np.float32))
             for s in shapes]
    assert [TL._grad_view(g) is None for g in grads] == [
        False, True, False, True, True]
    got = _emulate(params, grads)
    for o, p, g in zip(got, params, grads):
        assert torch.equal(o, sgd_update_ref(p, g, lr=LR, wd=WD))


# ---------------------------------------------------------------------------
# (c) the CPU route
# ---------------------------------------------------------------------------

def test_tree_update_with_views_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(8)
    params = {"w": torch.from_numpy(rng.normal(size=(3, 3, 4, 6))
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(6,))
                                    .astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.normal(size=(6, 4, 3, 3))
                                   .astype(np.float32)).permute(2, 3, 1, 0),
             "b": torch.from_numpy(rng.normal(size=(6,))
                                   .astype(np.float32))}
    launches = TL.sgd_f32.launches
    out = TL.sgd_update_tree(params, grads, lr=LR, wd=WD)
    assert TL.sgd_f32.launches == launches
    for k in params:
        assert torch.equal(out[k], sgd_update_ref(params[k], grads[k],
                                                  lr=LR, wd=WD))
    with pytest.raises(ValueError, match="not CUDA"):
        TL.sgd_f32(list(params.values()), list(grads.values()), lr=LR)
