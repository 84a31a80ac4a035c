"""`python -m repro_torch.launch.train` on the vlm, RWKV6 and hybrid
families (chameleon-34b, rwkv6-7b, zamba2-7b at their `reduced()` sizes),
against the reference's `repro.launch.train`, on the CPU: the `--out`
reports' task losses and held-out -nll and the `--handoff-dir` files per
leaf, from one init, as `test_torch_train_cli.py` holds the dense, MoE
and MLA families (its docstring and `_train_cli_parity.py` say how,
with the one-ulp controls every tolerance is widened by).

Tolerances, the families' own tests':
- vlm (`test_torch_lm_train.py`, as dense): task losses rtol 1e-5,
  held-out NLL rtol 1e-4, final params 1e-4 normwise per leaf;
- RWKV6 and the hybrid (`test_torch_ssm_models.py`): task losses and
  held-out NLL rtol 1e-5 (its loss and logits), final params 1e-4
  normwise per leaf (its state entries)."""
import pytest
import torch

from _train_cli_parity import assert_pair_close, run_pair

torch.set_num_threads(2)

DENSE_TOL = dict(task_tol=1e-5, nll_tol=1e-4, param_tol=1e-4)
SSM_TOL = dict(task_tol=1e-5, nll_tol=1e-5, param_tol=1e-4)


@pytest.mark.parametrize("arch,tol", [
    ("chameleon-34b", DENSE_TOL),
    ("rwkv6-7b", SSM_TOL),
    ("zamba2-7b", SSM_TOL)], ids=["vlm", "rwkv6", "hybrid"])
def test_cli_matches_reference(arch, tol, monkeypatch, tmp_path, capsys):
    runs, out = run_pair(monkeypatch, tmp_path, arch)
    assert_pair_close(runs, **tol)
    printed = capsys.readouterr().out
    assert f"arch={arch} -nll=" in printed and "read back bitwise" in printed
    assert out["-nll"] == runs["port"][0]["-nll"]
