"""`python -m repro_torch.launch.train` on language models, against the
reference's `repro.launch.train`, on the CPU: the dense, MoE and MLA
families (llama3.2-1b, qwen3-moe-235b-a22b, deepseek-v2-lite-16b at their
`reduced()` sizes, as both CLIs take them; deepseek's MLA heads q/k 48
over v 32), llama3.2-1b through the low-rank factor pool, the
`--reduced` / `paper-cnn` rule, the metric's name, and the
encoder-decoder's refusal. The vlm, RWKV6 and hybrid families are in
`test_torch_train_cli_ssm.py`.

Each pair runs one tiny argv (2 clients, pool 2, e_warmup 2, e_local 2,
128 sequences of 32 tokens, batch 4; lr 1e-3 as the CLI's default) from
one init, and compares the `--out` reports' task losses and held-out
-nll (after each client and at the end) and the two `--handoff-dir`
files per leaf (the reference's read by the port's `load_pytree`); see
`_train_cli_parity.py` for the one-ulp controls every tolerance is
widened by (CONTROL_FACTOR × their distance from the port's run).

Tolerances, the families' own training tests':
- dense (`test_torch_lm_train.py`): task losses rtol 1e-5, held-out NLL
  rtol 1e-4, final params 1e-4 normwise per leaf;
- MoE and MLA (`test_torch_moe_train.py`): task losses and held-out NLL
  rtol 1e-5, final params 1e-5 normwise per leaf."""
import json
import sys

import numpy as np
import pytest
import torch

import repro.launch.train as JT
import repro_torch.launch.train as TT
from _train_cli_parity import assert_pair_close, run_pair
from repro_torch.configs import get_arch

torch.set_num_threads(2)

DENSE_TOL = dict(task_tol=1e-5, nll_tol=1e-4, param_tol=1e-4)
MOE_TOL = dict(task_tol=1e-5, nll_tol=1e-5, param_tol=1e-5)


@pytest.mark.parametrize("arch,extra,tol", [
    ("llama3.2-1b", [], DENSE_TOL),
    ("llama3.2-1b", ["--pool-backend", "lowrank"], DENSE_TOL),
    ("qwen3-moe-235b-a22b", [], MOE_TOL),
    ("deepseek-v2-lite-16b", [], MOE_TOL)],
    ids=["dense", "dense-lowrank", "moe", "mla"])
def test_cli_matches_reference(arch, extra, tol, monkeypatch, tmp_path,
                               capsys):
    runs, out = run_pair(monkeypatch, tmp_path, arch, extra)
    assert_pair_close(runs, **tol)
    printed = capsys.readouterr().out
    assert "-nll=" in printed and "read back bitwise" in printed
    assert "none of the clients trained on" in printed
    assert set(out) == {"method", "arch", "-nll", "wall_s", "history"}
    assert out["-nll"] == runs["port"][0]["-nll"]


def test_reduced_rule(monkeypatch):
    """`--reduced` or a non-CNN family takes `reduced()`; `paper-cnn`
    never does, as in the reference (repro/launch/train.py:114-116)."""
    built = []

    def build(cfg, device=None):
        built.append(cfg)
        raise StopIteration

    monkeypatch.setattr(TT, "build_model", build)
    for argv, want in (
            (["--arch", "paper-cnn"], get_arch("paper-cnn")),
            (["--arch", "paper-cnn", "--reduced"], get_arch("paper-cnn")),
            (["--arch", "llama3.2-1b"], get_arch("llama3.2-1b").reduced()),
            (["--arch", "chameleon-34b", "--reduced"],
             get_arch("chameleon-34b").reduced())):
        with pytest.raises(StopIteration):
            TT.main(argv + ["--device", "cpu"])
        assert built.pop() == want, argv


def test_metric_name(tmp_path):
    """`acc` for the CNN (phase 21's `acc=` line), `-nll` for an LM: in the
    printed line, the `--out` file and the dict `main` returns."""
    for arch, metric in (("paper-cnn", "acc"), ("llama3.2-1b", "-nll")):
        out = TT.main(["--arch", arch, "--device", "cpu", "--clients", "2",
                       "--pool", "2", "--e-local", "1", "--e-warmup", "1",
                       "--samples", "128", "--seq-len", "16", "--batch", "4",
                       "--out", str(tmp_path / f"{arch}.json")])
        with open(tmp_path / f"{arch}.json") as f:
            report = json.load(f)
        assert metric in out and metric in report, arch
        other = "-nll" if metric == "acc" else "acc"
        assert other not in out and other not in report, arch
        assert np.isfinite(out[metric])
    assert out["-nll"] < 0


def test_no_gpu_without_device_cpu_raises(monkeypatch):
    """Without a card and without `--device cpu`, `main` raises before it
    builds a model: no path carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(TT, "build_model", None)
    for arch in ("paper-cnn", "llama3.2-1b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.main(["--arch", arch])


def test_encdec_raises_where_the_reference_crashes(monkeypatch):
    """seamless-m4t-medium: the reference's CLI builds {tokens, labels}
    batches and its encoder-decoder loss reads `src_embeds`, a KeyError
    (ROADMAP C22); the port refuses by name before any data is built. When
    the reference is fixed, the first check fails and says so."""
    argv = ["--arch", "seamless-m4t-medium", "--clients", "2", "--pool",
            "2", "--e-local", "1", "--e-warmup", "1", "--samples", "64",
            "--seq-len", "16", "--batch", "4"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    try:
        JT.main()
    except KeyError as e:
        assert "src_embeds" in str(e)
    else:
        pytest.fail("the reference's CLI now trains the encoder-decoder: "
                    "ROADMAP C22 is fixed there, so port the fix")
    monkeypatch.setattr(TT, "build_clients", None)   # no data is built
    with pytest.raises(ValueError, match="encoder-decoder.*src_embeds"):
        TT.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match="C22"):
        TT.main(argv)            # before the device: the named error here too
