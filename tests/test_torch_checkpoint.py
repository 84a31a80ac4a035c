"""Port parity for `repro_torch.checkpoint` against the JAX package's
`repro.checkpoint`, on the CPU: the same npz files from both packages.

* A params dict and the three pool kinds (stacked, moment, low-rank) of
  the paper CNN at width 8 / d_ff 16: each package's file has the same
  keys, shapes and dtypes; reference save → port load and port save →
  reference load are bitwise, in f32.
* bf16 leaves: reference save → port load is bitwise, and a port save
  writes the same member arrays: dtype (`|V2` bit patterns), shape and
  data bytes. The reference's own loaders raise on a bf16 file (ROADMAP
  C13), so bf16 files cross in one direction only.
* Errors as the reference's: `save_pool` of a bare dict (TypeError),
  `load_pool` of a plain file (ValueError), a shape mismatch; and a bf16
  leaf into an f32 template raises instead of casting.
* Fleet round files: the path, the newest round, an empty directory.
* `PoolServer.from_checkpoint` scores equal `from_pool`'s, bitwise, for a
  narrow CNN stacked pool and a tiny llama factor pool (f32 and a bf16
  base written by the reference).
* `python -m repro_torch.launch.train` on the CPU at a tiny size; its
  handoff file loads in the reference's `load_pytree` (the LM archs:
  `test_torch_train_cli.py`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as JC
import repro_torch.checkpoint as TC
from repro.configs import get_arch as jax_get_arch
from repro.core.pool import LowRankDeltaPool as JaxLowRankPool
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.pool import MomentPool as JaxMomentPool
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_params, from_jax_pool, to_jax_params
from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.serve import PoolServer

torch.set_num_threads(2)

NARROW = dict(d_model=8, d_ff=16)


@pytest.fixture(scope="module")
def jax_cnn():
    jm = jax_build_model(dataclasses.replace(jax_get_arch("paper-cnn"),
                                             **NARROW))
    inits = [jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(s)))
             for s in range(4)]
    return jm, inits


def _jax_pool(kind, inits):
    """A reference pool of `kind` over the narrow CNN's inits 0..3."""
    if kind == "stacked":
        pool = JaxModelPool.create(inits[0], 5)
    elif kind == "moment":
        pool = JaxMomentPool.create(inits[0])
    else:
        pool = JaxLowRankPool.create(inits[0], 5, 4)
    for m in inits[1:]:
        pool = pool.append(m)
    return jax.tree.map(np.asarray, pool)


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    out = []
    for x in (tree.values() if isinstance(tree, dict) else tree):
        out.extend(_torch_leaves(x) if isinstance(x, (dict, tuple))
                   else [x])
    return out


def _assert_torch_equal(got, want):
    g, w = _torch_leaves(got), _torch_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _assert_jax_equal(got, want):
    g, w = _jax_leaves(got), _jax_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _layout(path):
    with np.load(path) as d:
        return [(k, d[k].dtype.str, d[k].shape) for k in d.files]


def _members(path):
    """Each member array's dtype, shape and data bytes."""
    with np.load(path) as d:
        return {k: (d[k].dtype.str, d[k].shape, d[k].tobytes())
                for k in d.files}


KINDS = ["params", "stacked", "moment", "lowrank"]


def _objects(kind, inits):
    """(reference object, the port's counterpart) of `kind`."""
    if kind == "params":
        return inits[0], from_jax_params(inits[0], "cpu")
    jpool = _jax_pool(kind, inits)
    return jpool, from_jax_pool(jpool, "cpu")


def _save(pkg, kind, path, obj):
    (pkg.save_pytree if kind == "params" else pkg.save_pool)(path, obj)


def _jax_load(kind, path, inits):
    if kind == "params":
        return JC.load_pytree(path, inits[0])
    return JC.load_pool(path, inits[0])


def _torch_load(kind, path, inits):
    like = from_jax_params(inits[0], "cpu")
    if kind == "params":
        return TC.load_pytree(path, like)
    return TC.load_pool(path, like)


@pytest.mark.parametrize("kind", KINDS)
def test_files_have_the_reference_layout(kind, jax_cnn, tmp_path):
    _, inits = jax_cnn
    jobj, tobj = _objects(kind, inits)
    _save(JC, kind, str(tmp_path / "ref.npz"), jobj)
    _save(TC, kind, str(tmp_path / "port.npz"), tobj)
    assert _layout(tmp_path / "port.npz") == _layout(tmp_path / "ref.npz")
    # the same values: the archives' members are byte for byte the same
    assert _members(tmp_path / "port.npz") == _members(tmp_path / "ref.npz")


@pytest.mark.parametrize("kind", KINDS)
def test_reference_save_port_load_bitwise(kind, jax_cnn, tmp_path):
    _, inits = jax_cnn
    jobj, tobj = _objects(kind, inits)
    path = str(tmp_path / "ref.npz")
    _save(JC, kind, path, jobj)
    got = _torch_load(kind, path, inits)
    assert type(got) is type(tobj)
    _assert_torch_equal(got, tobj)


@pytest.mark.parametrize("kind", KINDS)
def test_port_save_reference_load_bitwise(kind, jax_cnn, tmp_path):
    _, inits = jax_cnn
    jobj, tobj = _objects(kind, inits)
    path = str(tmp_path / "port.npz")
    _save(TC, kind, path, tobj)
    got = _jax_load(kind, path, inits)
    assert type(got).__name__ == type(jobj).__name__
    _assert_jax_equal(got, jobj)


@pytest.mark.parametrize("make", [
    lambda p: ModelPool.create(p[0], 4).append(p[1]).append(p[2]),
    lambda p: MomentPool.create(p[0]).append(p[1]).append(p[2]),
    lambda p: LowRankDeltaPool.create(p[0], 4, 3).append(p[1]).append(p[2])],
    ids=["stacked", "moment", "lowrank"])
def test_port_pools_round_trip(make, tmp_path):
    model = build_model(dataclasses.replace(get_arch("paper-cnn"), **NARROW),
                        device="cpu")
    pool = make([model.init(s) for s in range(3)])
    TC.save_pool(str(tmp_path / "pool.npz"), pool)
    got = TC.load_pool(str(tmp_path / "pool.npz"), model.init(7))
    assert type(got) is type(pool)
    _assert_torch_equal(got, pool)
    assert int(got.count) == 3


def _bf16(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                        tree)


def test_bf16_reference_save_port_load_and_same_bytes(jax_cnn, tmp_path):
    """A bf16 params file and a low-rank pool on a bf16 base: the port
    reads the reference's files bit for bit and writes the same arrays."""
    _, inits = jax_cnn
    params = _bf16(inits[0])
    pool = JaxLowRankPool.create(params, 4, 3)
    for m in inits[1:3]:
        pool = pool.append(_bf16(m))
    pool = jax.tree.map(np.asarray, pool)
    like = from_jax_params(params, "cpu")
    assert like["c1.w"].dtype == torch.bfloat16

    JC.save_pytree(str(tmp_path / "ref_p.npz"), params)
    JC.save_pool(str(tmp_path / "ref_pool.npz"), pool)
    assert dict((k, d) for k, d, _ in _layout(tmp_path / "ref_p.npz"))[
        "c1::w"] == "|V2"
    _assert_torch_equal(TC.load_pytree(str(tmp_path / "ref_p.npz"), like),
                        like)
    tpool = from_jax_pool(pool, "cpu")
    _assert_torch_equal(TC.load_pool(str(tmp_path / "ref_pool.npz"), like),
                        tpool)

    TC.save_pytree(str(tmp_path / "port_p.npz"), like)
    TC.save_pool(str(tmp_path / "port_pool.npz"), tpool)
    assert _members(tmp_path / "port_p.npz") == \
        _members(tmp_path / "ref_p.npz")
    assert _members(tmp_path / "port_pool.npz") == \
        _members(tmp_path / "ref_pool.npz")


def test_errors_as_the_reference(jax_cnn, tmp_path):
    _, inits = jax_cnn
    tparams = from_jax_params(inits[0], "cpu")
    for pkg, params in ((JC, inits[0]), (TC, tparams)):
        with pytest.raises(TypeError, match="save_pytree"):
            pkg.save_pool(str(tmp_path / "x.npz"), params)
    plain = str(tmp_path / "plain.npz")
    JC.save_pytree(plain, inits[0])
    with pytest.raises(ValueError, match="not a save_pool checkpoint"):
        JC.load_pool(plain, inits[0])
    with pytest.raises(ValueError, match="not a save_pool checkpoint"):
        TC.load_pool(plain, tparams)
    # a template of another shape raises in both
    wide = jax_build_model(jax_get_arch("paper-cnn")).init(
        jax.random.PRNGKey(0))
    with pytest.raises(AssertionError):
        JC.load_pytree(plain, wide)
    with pytest.raises(ValueError, match="shape"):
        TC.load_pytree(plain, from_jax_params(
            jax.tree.map(np.asarray, wide), "cpu"))
    # bf16 bit patterns never load into an f32 leaf
    bf = str(tmp_path / "bf16.npz")
    JC.save_pytree(bf, _bf16(inits[0]))
    with pytest.raises(ValueError, match="bf16"):
        TC.load_pytree(bf, tparams)


def test_fleet_round_files(jax_cnn, tmp_path):
    _, inits = jax_cnn
    d = str(tmp_path / "rounds")
    assert TC.fleet_round_path(d, 7) == JC.fleet_round_path(d, 7)
    assert TC.latest_fleet_round(d, inits[0]) == (None, None)
    like = from_jax_params(inits[0], "cpu")
    for r in (0, 2, 1):
        TC.save_fleet_round(d, r, from_jax_params(inits[r], "cpu"))
    r, got = TC.latest_fleet_round(d, like)
    assert r == 2
    _assert_torch_equal(got, from_jax_params(inits[2], "cpu"))
    # the reference resumes from the port's round files, and back
    r, got = JC.latest_fleet_round(d, inits[0])
    assert r == 2
    _assert_jax_equal(got, inits[2])
    JC.save_fleet_round(d, 3, inits[3])
    r, got = TC.latest_fleet_round(d, like)
    assert r == 3
    _assert_torch_equal(got, from_jax_params(inits[3], "cpu"))


def test_from_checkpoint_scores_equal_from_pool_cnn(jax_cnn, tmp_path):
    _, inits = jax_cnn
    model = build_model(dataclasses.replace(get_arch("paper-cnn"), **NARROW),
                        device="cpu")
    pool = from_jax_pool(_jax_pool("stacked", inits), "cpu")
    path = str(tmp_path / "pool.npz")
    TC.save_pool(path, pool)
    batch = {"images": torch.from_numpy(np.random.default_rng(0).normal(
        size=(6, 32, 32, 3)).astype(np.float32))}
    want, wp = PoolServer.from_pool(model, pool).score_batch(batch)
    got, gp = PoolServer.from_checkpoint(model, path,
                                         model.init(0)).score_batch(batch)
    assert torch.equal(got, want) and np.array_equal(gp, wp)


def _tiny_llama(param_dtype):
    kw = dict(n_layers=2, n_kv_heads=2, d_model=64, head_dim=16, d_ff=128,
              vocab_size=96, param_dtype=param_dtype)
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("llama3.2-1b").reduced(), **kw))
    tm = build_model(dataclasses.replace(
        get_arch("llama3.2-1b").reduced(), **kw), device="cpu")
    return jm, tm


TOKENS = np.random.default_rng(3).integers(0, 96, (2, 12)).astype(np.int32)


def test_from_checkpoint_scores_equal_from_pool_llama_f32(tmp_path):
    _, tm = _tiny_llama("float32")
    pool = LowRankDeltaPool.create(tm.init(0), capacity=4, rank=4)
    for s in (1, 2):
        pool = pool.append(tm.init(s))
    path = str(tmp_path / "llama.npz")
    TC.save_pool(path, pool)
    batch = {"tokens": torch.from_numpy(TOKENS)}
    want = PoolServer.from_pool(tm, pool)
    got = PoolServer.from_checkpoint(tm, path, tm.init(9))
    assert want.factored and got.factored
    assert torch.equal(got.score_batch(batch)[0], want.score_batch(batch)[0])


def test_from_checkpoint_reads_the_reference_bf16_factor_pool(tmp_path):
    """A factor pool on a bf16 base written by the reference serves from
    the file as from the pool carried across in memory."""
    _, tm = _tiny_llama("bfloat16")
    inits = [_bf16(to_jax_params({k: v.float()
                                  for k, v in tm.init(s).items()}))
             for s in range(3)]
    assert inits[0]["embed"].dtype.name == "bfloat16"
    jpool = JaxLowRankPool.create(inits[0], capacity=4, rank=4)
    for m in inits[1:]:
        jpool = jpool.append(m)
    jpool = jax.tree.map(np.asarray, jpool)
    path = str(tmp_path / "llama_bf16.npz")
    JC.save_pool(path, jpool)
    batch = {"tokens": torch.from_numpy(TOKENS)}
    want = PoolServer.from_pool(tm, from_jax_pool(jpool, "cpu"))
    got = PoolServer.from_checkpoint(tm, path, tm.init(0))
    assert torch.equal(got.score_batch(batch)[0], want.score_batch(batch)[0])


def test_train_cli_handoff_loads_in_the_reference(jax_cnn, tmp_path,
                                                  capsys):
    _, inits = jax_cnn
    out = train_cli.main([
        "--device", "cpu", "--clients", "2", "--pool", "2", "--e-local", "2",
        "--e-warmup", "1", "--samples", "200", "--batch", "8",
        "--handoff-dir", str(tmp_path), "--out", str(tmp_path / "o.json")])
    printed = capsys.readouterr().out
    assert "read back bitwise" in printed and "acc=" in printed
    assert 0.0 <= out["acc"] <= 1.0 and (tmp_path / "o.json").exists()
    path = str(tmp_path / "m_final.npz")
    wide = jax.tree.map(np.asarray, jax_build_model(
        jax_get_arch("paper-cnn")).init(jax.random.PRNGKey(0)))
    ref = JC.load_pytree(path, wide)
    port = TC.load_pytree(path, from_jax_params(wide, "cpu"))
    _assert_torch_equal(from_jax_params(jax.tree.map(np.asarray, ref),
                                        "cpu"), port)
    # the encoder-decoder is the one arch the CLI refuses (ROADMAP C22)
    with pytest.raises(ValueError, match="src_embeds"):
        train_cli.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])
