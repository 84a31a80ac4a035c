"""What `test_torch_train_cli.py` and `test_torch_train_cli_ssm.py` share:
one tiny argv through the reference's `repro.launch.train.main` and the
port's `repro_torch.launch.train.main`, from one init, and the comparison
of their `--out` reports and `--handoff-dir` files.

Both packages' `launch` (as their `train` modules import it) is patched
to start from the reference's `model.init(PRNGKey(seed))`, which the port
gets through `convert.from_jax_params`. The port also runs twice more
from that init nudged by one ulp, up and down (the controls).

Why controls. The CLI trains at lr 1e-3 with Adam: a gradient element
small enough for its sign to be decided by f32 rounding moves by ±lr, so
two runs whose sums are taken in another order end apart by a few such
flips a leaf, and a leaf that starts at 0 (a bias) is far apart relative
to its own norm. The port nudged by one ulp lies as far from the port as
the reference does. So each quantity is held within its family's
tolerance plus CONTROL_FACTOR times the larger of the two controls'
distances from the port's run: a fault (a wrong kernel, a wrong mask, a
dropped term) moves the run by far more than that."""
import dataclasses
import json
import sys

import jax
import numpy as np
import torch

import repro.launch.train as JT
import repro_torch.launch.train as TT
from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import load_pytree
from repro_torch.convert import from_jax_params

ARGV = ["--clients", "2", "--pool", "2", "--e-warmup", "2", "--e-local", "2",
        "--samples", "128", "--seq-len", "32", "--batch", "4"]
CONTROL_FACTOR = 3.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _init(arch):
    cfg = jax_get_arch(arch).reduced()
    return jax.tree.map(np.asarray,
                        jax_build_model(cfg).init(jax.random.PRNGKey(0)))


def _nudged(params, to):
    return {k: torch.nextafter(v, torch.full_like(v, to))
            for k, v in params.items()}


def _port_run(monkeypatch, arch, init, tmp, extra):
    monkeypatch.setattr(TT, "launch", lambda exp, _l=TT.launch: _l(
        dataclasses.replace(exp, init_params=init)))
    tmp.mkdir()
    out = TT.main(["--arch", arch] + ARGV + extra + [
        "--device", "cpu", "--handoff-dir", str(tmp),
        "--out", str(tmp / "out.json")])
    with open(tmp / "out.json") as f:
        report = json.load(f)
    params = load_pytree(str(tmp / "m_final.npz"),
                         {k: torch.empty_like(v) for k, v in init.items()})
    monkeypatch.undo()
    return out, report, params


def run_pair(monkeypatch, tmp_path, arch, extra=()):
    """The reference's and the port's runs of `arch` (and the two
    controls): {"ref", "port", "up", "down"} → (report, params), the
    reference's handoff file read by the port's `load_pytree`, and the
    dict the port's `main` returned."""
    extra = list(extra)
    jinit = _init(arch)
    monkeypatch.setattr(JT, "launch", lambda exp, _l=JT.launch: _l(
        dataclasses.replace(exp, init_params=jax.tree.map(jax.numpy.asarray,
                                                          jinit))))
    (tmp_path / "ref").mkdir()
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch] + ARGV + extra
                        + ["--handoff-dir", str(tmp_path / "ref"),
                           "--out", str(tmp_path / "ref" / "out.json")])
    JT.main()
    monkeypatch.undo()
    init = from_jax_params(jinit, "cpu")
    with open(tmp_path / "ref" / "out.json") as f:
        runs = {"ref": (json.load(f), load_pytree(
            str(tmp_path / "ref" / "m_final.npz"),
            {k: torch.empty_like(v) for k, v in init.items()}))}
    returned = None
    for name, start in (("port", init),
                        ("up", _nudged(init, float("inf"))),
                        ("down", _nudged(init, float("-inf")))):
        out, report, params = _port_run(monkeypatch, arch, start,
                                        tmp_path / name, extra)
        runs[name] = (report, params)
        returned = returned or out
    return runs, returned


def _tasks(report):
    return [m["task_loss"] for c in report["history"] for m in c["models"]]


def _nlls(report):
    return [c["global_acc"] for c in report["history"]] + [report["-nll"]]


def _scalar_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def assert_pair_close(runs, task_tol, param_tol, nll_tol):
    """The port's report and params against the reference's: task losses,
    the held-out -nll after each client and at the end, and each final
    leaf (normwise), each within its tolerance plus CONTROL_FACTOR × the
    controls' distance from the port's run."""
    (rep_j, par_j), (rep_t, par_t) = runs["ref"], runs["port"]
    controls = [runs["up"], runs["down"]]
    assert len(_tasks(rep_t)) == len(_tasks(rep_j)) > 0
    for what, get, tol in (("task losses", _tasks, task_tol),
                           ("held-out -nll", _nlls, nll_tol)):
        err = _scalar_rel(get(rep_t), get(rep_j))
        ctl = max(_scalar_rel(get(r), get(rep_t)) for r, _ in controls)
        assert err <= tol + CONTROL_FACTOR * ctl, (what, err, ctl)
    assert list(par_t) == list(par_j)
    for k in par_j:
        assert torch.isfinite(par_t[k]).all(), k
        err = _rel(par_t[k].numpy(), par_j[k].numpy())
        ctl = max(_rel(p[k].numpy(), par_t[k].numpy()) for _, p in controls)
        assert err <= param_tol + CONTROL_FACTOR * ctl, (k, err, ctl)
