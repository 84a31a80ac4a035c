"""Port parity for `repro_torch.data.plan` against `repro.data.plan`, on
the CPU: the schedule rows, `take` and `peek_schedule` bitwise over
several (seed, n, batch); `take` and iteration through one cursor; the
ragged-batch refusal; `stack_plan_arrays` / `stack_plan_indices`; the
plan's batches against the port's own `batch_iterator`. All bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import plan as JP
from repro_torch.data import plan as TP
from repro_torch.data import batch_iterator

torch.set_num_threads(2)

# (seed, n, batch): full epochs, a remainder dropped, a batch larger than
# n (clipped to n), one-batch epochs
GRID = [(0, 40, 8), (3, 37, 5), (7, 12, 16), (11, 9, 9), (5, 100, 7)]


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(n, 4, 4, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def _plans(seed, n, bs, **kw):
    arr = _arrays(n, seed)
    return (JP.DataPlan(arr, bs, seed=seed, **kw),
            TP.DataPlan(arr, bs, seed=seed, device="cpu", **kw), arr)


@pytest.mark.parametrize("seed,n,bs", GRID)
def test_schedule_rows_bitwise(seed, n, bs):
    jp, tp, _ = _plans(seed, n, bs)
    assert tp.batch_size == jp.batch_size and tp.n == jp.n
    assert tp.steps_per_epoch == jp.steps_per_epoch
    want = jp.peek_schedule(40)
    got = tp.peek_schedule(40)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for k in (3, 1, 17):
        rows_j = np.asarray(jp.take(k))
        rows_t = tp.take(k)
        assert rows_t.dtype == torch.int32
        assert np.array_equal(rows_t.numpy(), rows_j)


@pytest.mark.parametrize("seed,n,bs", GRID)
def test_take_and_next_share_one_cursor(seed, n, bs):
    jp, tp, arr = _plans(seed, n, bs)
    for step in range(30):
        if step % 4 == 3:
            assert np.array_equal(tp.take(2).numpy(),
                                  np.asarray(jp.take(2)))
            continue
        jb, tb = next(jp), next(tp)
        for k in arr:
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), k
    # the window of rows `next` keeps on the device serves a later `take`
    assert np.array_equal(tp.take(5).numpy(), np.asarray(jp.take(5)))


@pytest.mark.parametrize("seed,n,bs", GRID[:3])
def test_plan_batches_are_the_iterators(seed, n, bs):
    _, tp, arr = _plans(seed, n, bs)
    it = batch_iterator(arr, bs, seed=seed, device="cpu")
    for _ in range(25):
        got, want = next(tp), next(it)
        for k in arr:
            assert torch.equal(got[k], want[k]), k


def test_ragged_final_batch_raises_as_the_reference():
    arr = _arrays(10, 0)
    with pytest.raises(ValueError) as want:
        JP.DataPlan(arr, 4, drop_remainder=False)
    with pytest.raises(ValueError) as got:
        TP.DataPlan(arr, 4, drop_remainder=False, device="cpu")
    assert str(got.value) == str(want.value)
    # an exact multiple is fine with or without the remainder rule
    TP.DataPlan(_arrays(12, 0), 4, drop_remainder=False, device="cpu")


def test_arrays_must_agree_in_length():
    with pytest.raises(ValueError, match="length"):
        TP.DataPlan({"a": np.zeros(3), "b": np.zeros(4)}, 2, device="cpu")


@pytest.mark.parametrize("pad_to", [None, 50])
def test_stack_plan_arrays_and_indices_match(pad_to):
    sizes = [(40, 1), (33, 2), (45, 3)]
    jplans = [JP.DataPlan(_arrays(n, s), 5, seed=s) for n, s in sizes]
    tplans = [TP.DataPlan(_arrays(n, s), 5, seed=s, device="cpu")
              for n, s in sizes]
    want = JP.stack_plan_arrays(jplans, pad_to=pad_to)
    got = TP.stack_plan_arrays(tplans, pad_to=pad_to)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for n_steps in (3, 8):
        assert np.array_equal(
            TP.stack_plan_indices(tplans, n_steps).numpy(),
            np.asarray(JP.stack_plan_indices(jplans, n_steps)))


def test_stack_plan_refuses_mismatched_shards():
    a = TP.DataPlan(_arrays(10, 0), 5, device="cpu")
    b = TP.DataPlan({"images": np.zeros((10, 2, 2, 3), np.float32),
                     "labels": np.zeros(10, np.int32)}, 5, device="cpu")
    with pytest.raises(ValueError, match="structurally identical"):
        TP.stack_plan_arrays([a, b])
    c = TP.DataPlan(_arrays(10, 0), 2, device="cpu")
    with pytest.raises(ValueError, match="one batch size"):
        TP.stack_plan_indices([a, c], 2)


def test_wants_scan_routes_as_the_reference():
    arr = _arrays(10, 0)
    plans = [TP.DataPlan(arr, 5, device="cpu"),
             TP.DataPlan(arr, 5, scan=False, device="cpu")]
    assert [TP.wants_scan(p) for p in plans] == [True, False]
    assert not TP.wants_scan(batch_iterator(arr, 5, device="cpu"))
    assert TP.all_want_scan(plans[:1]) and not TP.all_want_scan(plans)
    assert JP.wants_scan(JP.DataPlan(arr, 5)) and not JP.wants_scan(
        JP.DataPlan(arr, 5, scan=False))


def test_device_arrays_are_taken_as_they_are():
    """Arrays already tensors stay on their device, shared, not copied;
    numpy arrays are uploaded once."""
    t = {"images": torch.zeros(8, 2), "labels": torch.arange(8)}
    plan = TP.DataPlan(t, 4, device="cpu")
    assert plan.arrays["images"].data_ptr() == t["images"].data_ptr()
    assert plan.device == torch.device("cpu")
    assert isinstance(TP.DataPlan(_arrays(8, 0), 4,
                                  device="cpu").arrays["labels"],
                      torch.Tensor)
    assert jnp.asarray(JP.DataPlan(_arrays(8, 0), 4).take(1)).dtype == \
        jnp.int32
