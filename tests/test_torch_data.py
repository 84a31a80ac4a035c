"""Port parity: the numpy data plane of `repro_torch.data` is bitwise equal
to `repro.data` — synthetic images, Dirichlet label-skew partitions (with
their bounded retry), the four shifted domains and their per-client
partition, and the shuffled batch streams — for several seeds.
Tolerance: none; every comparison is exact equality."""
import numpy as np
import pytest
import torch

from repro.data import batch_iterator as jax_batch_iterator
from repro.data import dirichlet_partition as jax_dirichlet_partition
from repro.data import make_image_dataset as jax_make_image_dataset
from repro.data.partition import \
    domain_shift_partition as jax_domain_shift_partition
from repro.data.synthetic import apply_domain as jax_apply_domain
from repro.data.synthetic import \
    make_domain_datasets as jax_make_domain_datasets
from repro_torch.data import (apply_domain, batch_iterator,
                              dirichlet_partition, domain_shift_partition,
                              make_domain_datasets, make_image_dataset)

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,means_seed,noise", [(0, 0, 1.0), (3, 0, 2.5),
                                                   (7, 2, 0.5)])
def test_make_image_dataset_bitwise(seed, means_seed, noise):
    ref = jax_make_image_dataset(n_samples=64, seed=seed, noise=noise,
                                 means_seed=means_seed)
    out = make_image_dataset(n_samples=64, seed=seed, noise=noise,
                             means_seed=means_seed)
    assert out.images.dtype == ref.images.dtype == np.float32
    assert out.labels.dtype == ref.labels.dtype == np.int32
    assert np.array_equal(out.images, ref.images)
    assert np.array_equal(out.labels, ref.labels)
    assert out.n_classes == ref.n_classes


@pytest.mark.parametrize("seed,n_clients,beta,min_size", [
    (0, 4, 0.3, 2), (1, 3, 0.5, 2), (5, 10, 0.1, 2),
    # tight min_size: the first draws fail and the bounded retry resamples
    (2, 8, 0.05, 20)])
def test_dirichlet_partition_bitwise(seed, n_clients, beta, min_size):
    labels = jax_make_image_dataset(n_samples=400, seed=seed).labels
    ref = jax_dirichlet_partition(labels, n_clients, beta, seed=seed,
                                  min_size=min_size)
    out = dirichlet_partition(labels, n_clients, beta, seed=seed,
                              min_size=min_size)
    assert len(out) == len(ref) == n_clients
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype
        assert np.array_equal(o, r)


@pytest.mark.parametrize("kwargs", [dict(n_clients=0, beta=0.3),
                                    dict(n_clients=50, beta=0.3,
                                         min_size=10),
                                    dict(n_clients=8, beta=0.01,
                                         min_size=40)])
def test_dirichlet_partition_errors_identical(kwargs):
    labels = jax_make_image_dataset(n_samples=400, seed=0).labels
    with pytest.raises(ValueError) as ref:
        jax_dirichlet_partition(labels, **kwargs)
    with pytest.raises(ValueError) as out:
        dirichlet_partition(labels, **kwargs)
    assert str(out.value) == str(ref.value)


def _assert_same_dataset(out, ref):
    assert out.images.dtype == ref.images.dtype == np.float32
    assert out.labels.dtype == ref.labels.dtype == np.int32
    assert np.array_equal(out.images, ref.images)
    assert np.array_equal(out.labels, ref.labels)
    assert out.n_classes == ref.n_classes


@pytest.mark.parametrize("seed,noise", [(0, 2.0), (91, 2.0), (3, 0.8)])
def test_make_domain_datasets_bitwise(seed, noise):
    ref = jax_make_domain_datasets(40, noise=noise, seed=seed)
    out = make_domain_datasets(40, noise=noise, seed=seed)
    assert list(out) == list(ref) == ["photo", "art", "cartoon", "sketch"]
    for d in ref:
        _assert_same_dataset(out[d], ref[d])


@pytest.mark.parametrize("domain", ["photo", "art", "cartoon", "sketch"])
@pytest.mark.parametrize("severity", [0.0, 0.4, 1.0])
def test_apply_domain_bitwise(domain, severity):
    images = jax_make_image_dataset(n_samples=6, seed=2).images
    out = apply_domain(images, domain, severity)
    ref = jax_apply_domain(images, domain, severity)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)


@pytest.mark.parametrize("n_clients,order,seed", [
    (4, ("photo", "art", "cartoon", "sketch"), 0),
    (6, ("sketch", "photo", "art", "cartoon"), 3),
    (3, ("cartoon", "art"), 1)])
def test_domain_shift_partition_bitwise(n_clients, order, seed):
    doms = jax_make_domain_datasets(30, noise=1.0, seed=seed)
    ref = jax_domain_shift_partition(doms, n_clients, order=order, seed=seed)
    out = domain_shift_partition(doms, n_clients, order=order, seed=seed)
    assert len(out) == len(ref) == n_clients
    for o, r in zip(out, ref):
        _assert_same_dataset(o, r)


@pytest.mark.parametrize("seed,n,batch_size", [(0, 50, 8), (4, 33, 7),
                                               (9, 5, 8)])
def test_batch_iterator_stream_bitwise(seed, n, batch_size):
    """Three epochs' worth of batches, across reshuffles, equal value for
    value; the port yields tensors on the requested device."""
    ds = jax_make_image_dataset(n_samples=n, seed=seed)
    arrays = {"images": ds.images, "labels": ds.labels}
    ref = jax_batch_iterator(arrays, batch_size, seed=seed)
    out = batch_iterator(arrays, batch_size, seed=seed, device="cpu")
    steps = 3 * max(1, n // min(batch_size, n))
    for _ in range(steps):
        r, o = next(ref), next(out)
        assert set(o) == set(r)
        for k in r:
            assert o[k].device.type == "cpu"
            assert np.array_equal(o[k].numpy(), np.asarray(r[k]))
            assert o[k].numpy().dtype == np.asarray(r[k]).dtype


def test_batch_iterator_ragged_error_identical():
    arrays = {"x": np.zeros((10, 2), np.float32)}
    with pytest.raises(ValueError) as ref:
        next(jax_batch_iterator(arrays, 4, drop_remainder=False))
    with pytest.raises(ValueError) as out:
        next(batch_iterator(arrays, 4, drop_remainder=False, device="cpu"))
    assert str(out.value) == str(ref.value)


def test_batch_iterator_needs_gpu_or_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = batch_iterator({"x": np.zeros((4, 2), np.float32)}, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(it)
