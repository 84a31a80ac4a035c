"""Port parity for fleet-scale execution (`repro_torch.scenarios`:
`FleetSpec`, the fleet registry, `materialize_cohort`, `run_fleet`; and
`launch` of a fleet) against the JAX package's, on the CPU, mirroring
tests/test_fleet.py.

* Participation traces (uniform, cyclic) and `materialize_cohort` are
  bitwise the reference's; the specs' validation errors and the registered
  fleets are the reference's.
* On the paper CNN at width 8 / d_ff 16 (dfedavgm, e_local 3): a fleet
  run is deterministic; a run stopped after a round and resumed from its
  round file is bitwise the uninterrupted run; non-independent strategies
  are refused; the eval cadence; `launch` by spec and by name, bitwise
  `run_fleet`; `mesh=` raises "not ported yet".
* One trainer for a sweep: every round hands `interpret_batched` the same
  trainer, whose batched scanned phase keeps its buffers (so on the card
  its one capture) after round 0; a reused trainer trains on each round's
  own shards, bitwise a fresh trainer.
* Parity through the round files: the reference's `run_fleet` writes its
  round-0 aggregate and the port resumes from it, and the reverse; each
  resumed round 1 against the other package's from the same file: params
  atol 1e-5 and the accuracy within one test sample (test_torch_batch.py's
  tolerances)."""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.scenarios as JS
import repro_torch.api as T
import repro_torch.scenarios as TS
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.api import plan as plan_mod
from repro_torch.api.trainer import BatchedScannedPhase
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.models import build_model

torch.set_num_threads(2)

FED = dict(n_clients=4, pool_size=1, e_local=3, e_warmup=1,
           learning_rate=1e-3)
TINY = dict(name="tiny_test_fleet", fleet_size=1_000, cohort_size=4,
            rounds=2, samples_per_client=16, batch_size=8, n_test=64, seed=3)


@pytest.fixture(scope="module")
def tm():
    return build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=8,
                                           d_ff=16), device="cpu")


def _fleet(**kw):
    return TS.FleetSpec(**{**TINY, **kw})


def _run(fleet, model, **kw):
    return TS.run_fleet(fleet, model, fed=FedConfig(**FED), **kw)


def _assert_params_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# specs, traces, cohorts, the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("participation", ["uniform", "cyclic"])
@pytest.mark.parametrize("fleet_size,cohort_size,seed", [
    (1_000, 4, 3), (10, 4, 0), (100_000, 32, 0), (1_000_000, 64, 5)])
def test_traces_bitwise(participation, fleet_size, cohort_size, seed):
    kw = dict(name="t", fleet_size=fleet_size, cohort_size=cohort_size,
              participation=participation, seed=seed)
    got, want = TS.FleetSpec(**kw), JS.FleetSpec(**kw)
    for r in range(6):
        a, b = got.cohort(r), want.cohort(r)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(set(a.tolist())) == cohort_size
        assert a.min() >= 0 and a.max() < fleet_size


def test_cyclic_trace_walks_the_fleet():
    spec = _fleet(participation="cyclic", fleet_size=10)
    assert spec.cohort(0).tolist() == [0, 1, 2, 3]
    assert spec.cohort(2).tolist() == [8, 9, 0, 1]          # wraps


@pytest.mark.parametrize("r", [0, 1, 7])
def test_materialize_cohort_bitwise(r):
    got = TS.materialize_cohort(_fleet(), r)
    want = JS.materialize_cohort(JS.FleetSpec(**TINY), r)
    assert got.client_ids == want.client_ids and got.seed == want.seed
    assert len(got.client_data) == TINY["cohort_size"]
    for a, b in zip(got.client_data, want.client_data):
        for k in ("images", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    # the streams are the reference's batch sequences
    tp, jp = got.streams(to="cpu"), want.streams(device=False)
    for p, q in zip(tp, jp):
        for _ in range(3):
            a, b = next(p), next(q)
            assert np.array_equal(a["images"].numpy(), b["images"])


@pytest.mark.parametrize("bad", [dict(participation="lottery"),
                                 dict(cohort_size=0),
                                 dict(cohort_size=2_000), dict(rounds=0)])
def test_spec_validation_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        JS.FleetSpec(**{**TINY, **bad})
    with pytest.raises(ValueError) as got:
        TS.FleetSpec(**{**TINY, **bad})
    assert str(got.value) == str(want.value)


def test_registry_matches_the_reference():
    for name in ("fleet_100k", "fleet_1m_cyclic", "fleet_smoke"):
        assert name in TS.list_fleets()
        assert dataclasses.asdict(TS.get_fleet(name)) == \
            dataclasses.asdict(JS.get_fleet(name))
    assert TS.PARTICIPATIONS == JS.PARTICIPATIONS
    spec = TS.register_fleet(_fleet(name="tiny_registered_port"))
    assert TS.get_fleet("tiny_registered_port") is spec


# ---------------------------------------------------------------------------
# fleet runs
# ---------------------------------------------------------------------------

def test_fleet_run_deterministic(tm):
    r1, r2 = _run(_fleet(), tm), _run(_fleet(), tm)
    assert isinstance(r1, T.FleetResult)
    assert [c.clients for c in r1.cohorts] == \
        [TS.materialize_cohort(_fleet(), r).client_ids for r in range(2)]
    _assert_params_equal(r1.params, r2.params)
    assert r1.final_metric == r2.final_metric
    assert r1.clients_trained == TINY["cohort_size"] * TINY["rounds"]
    assert r1.fed.n_clients == TINY["cohort_size"]
    assert r1.clients_per_s() > 0 and r1.resumed_from is None


def test_fleet_resume_matches_uninterrupted(tm, tmp_path):
    fleet = _fleet(rounds=3)
    full = _run(fleet, tm)
    stopped = _run(fleet, tm, checkpoint_dir=str(tmp_path), rounds=2)
    assert [c.round for c in stopped.cohorts] == [0, 1]
    resumed = _run(fleet, tm, checkpoint_dir=str(tmp_path))
    assert resumed.resumed_from == 1
    assert [c.round for c in resumed.cohorts] == [2]
    _assert_params_equal(full.params, resumed.params)
    assert full.final_metric == resumed.final_metric


def test_fleet_rejects_non_independent_strategy(tm):
    for bad in ("fedelmy", "fedseq", "metafed"):
        with pytest.raises(ValueError, match="independent"):
            _run(_fleet(strategy=bad), tm)


def test_fleet_eval_cadence(tm):
    res = _run(_fleet(rounds=4), tm, eval_every=2)
    metrics = [c.global_metric for c in res.cohorts]
    assert metrics[0] is None and metrics[2] is None
    assert metrics[1] is not None and metrics[3] is not None
    assert res.final_metric == metrics[3]


def test_launch_fleet_by_spec_and_by_name(tm):
    direct = _run(_fleet(), tm)
    via_launch = T.launch(_fleet(), tm, fed=FedConfig(**FED))
    _assert_params_equal(direct.params, via_launch.params)
    TS.register_fleet(_fleet(name="tiny_by_name_port"))
    named = T.launch("tiny_by_name_port", tm, fed=FedConfig(**FED))
    _assert_params_equal(direct.params, named.params)
    with pytest.raises(ValueError, match="neither a registered fleet"):
        T.launch("no_such_target")
    with pytest.raises(ValueError, match="model= and fed="):
        T.launch(_fleet())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.launch(_fleet(), tm, fed=FedConfig(**FED), mesh=object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        _run(_fleet(), tm, mesh=object())


def test_sweep_keeps_one_trainer_and_its_buffers(tm, monkeypatch):
    """Every round runs on the sweep's one trainer, and its batched
    scanned phase keeps the buffers it made in round 0 (a buffer made
    anew drops the captured graphs: on the card, one capture a sweep)."""
    trainers, buffers = [], []
    real_interpret = plan_mod.interpret_batched
    real_buffers = BatchedScannedPhase._buffers

    def spy_interpret(exps, plan, mesh=None, *, _trainer=None):
        trainers.append(_trainer)
        return real_interpret(exps, plan, mesh, _trainer=_trainer)

    def spy_buffers(self, *args):
        real_buffers(self, *args)
        buffers.append((self, self.P, self.O, self.rows, self.arrays))

    monkeypatch.setattr(TS.compile, "interpret_batched", spy_interpret)
    monkeypatch.setattr(BatchedScannedPhase, "_buffers", spy_buffers)
    _run(_fleet(rounds=4), tm)
    assert len(trainers) == 4 and trainers[0] is not None
    assert all(t is trainers[0] for t in trainers)
    first = buffers[0]
    assert len(buffers) >= 8                   # _load and train, a round
    assert all(all(a is b for a, b in zip(first, row)) for row in buffers)


def _cohort_exp(fleet, tm, r, init, fed):
    cohort = TS.materialize_cohort(fleet, r)
    return T.Experiment(model=tm, client_iters=cohort.streams(to="cpu"),
                        fed=fed, strategy="dfedavgm",
                        seed=fleet.seed * 100003 + r, init_params=init)


def test_reused_trainer_trains_on_each_rounds_shards(tm):
    fleet = _fleet()
    fed = dataclasses.replace(FedConfig(**FED), n_clients=4)
    plan = T.get_plan("dfedavgm")
    c0, c1 = (TS.materialize_cohort(fleet, r) for r in (0, 1))
    assert not np.array_equal(c0.client_data[0]["images"],
                              c1.client_data[0]["images"])
    trainer = plan_mod._make_trainer(tm.loss_fn, fed, plan)
    init = tm.init(0)

    def round_on(r, trainer):
        exp = _cohort_exp(fleet, tm, r, init, fed)
        return plan_mod.interpret_batched([exp], plan,
                                          _trainer=trainer)[0].params

    round_on(0, trainer)        # round 0's plans go out of scope here
    reused = round_on(1, trainer)
    _assert_params_equal(reused, round_on(1, None))
    # and round 0's shards would have given other params
    assert any(not torch.equal(reused[k], v)
               for k, v in round_on(0, None).items())


@pytest.mark.parametrize("cohort", [32, 64])
def test_gemm_takes_a_registered_cohort_in_one_launch(cohort):
    """The full-width CNN's 8 step products at batch 16 with the run axis
    of fleet_100k's and fleet_1m_cyclic's cohorts fit one launch each (the
    c3 weight gradient splits K: 64 runs × 72 tiles need 4,608
    counters)."""
    from repro_torch.kernels import local_step as TL
    b, w = 16, 64
    products = [(b * 1024, 64, 27), (27, 64, b * 1024),            # c1
                (b * 256, 2 * w, 9 * w), (b * 256, 9 * w, 2 * w),
                (9 * w, 2 * w, b * 256),                           # c2
                (b * 64, 4 * w, 18 * w), (b * 64, 18 * w, 4 * w),
                (18 * w, 4 * w, b * 64)]                           # c3
    split = 0
    for m, n, k in products:
        plan = TL.gemm_plan(m, n, k)
        assert TL.runs_fit(plan, m, n, cohort), (m, n, k)
        split += plan.splits > 1
    assert split and not TL.runs_fit(TL.gemm_plan(1152, 256, 1024),
                                     1152, 256, 4096)


# ---------------------------------------------------------------------------
# parity with the reference through round files
# ---------------------------------------------------------------------------

def test_fleet_parity_through_round_files(tm, tmp_path):
    jm = jax_build_model(dataclasses.replace(jax_get_arch("paper-cnn"),
                                             d_model=8, d_ff=16))
    spec = dict(TINY, rounds=2, cohort_size=6, n_test=80)
    jfleet, tfleet = JS.FleetSpec(**spec), TS.FleetSpec(**spec)
    jfed, tfed = JaxFedConfig(**FED), FedConfig(**FED)

    def copy(src, name):
        dst = tmp_path / name
        shutil.copytree(src, dst)
        return str(dst)

    def compare(tres, jres):
        ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
        assert list(tres.params) == list(ref)
        for k in ref:
            np.testing.assert_allclose(tres.params[k].numpy(),
                                       ref[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)
        assert abs(tres.final_metric - jres.final_metric) <= \
            1.0 / spec["n_test"] + 1e-6

    # the reference writes round 0; each package resumes round 1 from it
    ref_dir = tmp_path / "ref"
    JS.run_fleet(jfleet, jm, fed=jfed, checkpoint_dir=str(ref_dir),
                 rounds=1)
    tres = TS.run_fleet(tfleet, tm, fed=tfed,
                        checkpoint_dir=copy(ref_dir, "ref_to_port"))
    jres = JS.run_fleet(jfleet, jm, fed=jfed,
                        checkpoint_dir=copy(ref_dir, "ref_to_ref"))
    assert tres.resumed_from == jres.resumed_from == 0
    assert [c.clients for c in tres.cohorts] == \
        [c.clients for c in jres.cohorts]
    compare(tres, jres)

    # the port writes round 0; each package resumes round 1 from it
    port_dir = tmp_path / "port"
    TS.run_fleet(tfleet, tm, fed=tfed, checkpoint_dir=str(port_dir),
                 rounds=1)
    jres = JS.run_fleet(jfleet, jm, fed=jfed,
                        checkpoint_dir=copy(port_dir, "port_to_ref"))
    tres = TS.run_fleet(tfleet, tm, fed=tfed,
                        checkpoint_dir=copy(port_dir, "port_to_port"))
    assert tres.resumed_from == jres.resumed_from == 0
    compare(tres, jres)
