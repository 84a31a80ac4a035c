"""Final accuracy of `chip_smoke.py` phase 8's Table 1 runs on the CPU: the
JAX reference (`repro.api.launch`) and the port (`repro_torch.api.launch`,
plain versions) on the same data, FedConfig and seeds, at full width.

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python tests/table1_reference_accuracy.py [strategy ...]

With no arguments it runs every (data family, strategy) of phase 8; with
strategy names, only those. It prints one line per run and package. The
two packages draw their inits differently (`jax.random` against
`torch.Generator`), so the runs start from different parameters and
their accuracies agree in kind, not to the sample. Accuracy is not a
device number: this script says what phase 8's runs reach, and whether
the reference reaches the same, not how fast either runs. (Not collected
by pytest: a full-width run takes tens of seconds.)"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import repro.api as J  # noqa: E402
import repro_torch.api as T  # noqa: E402
from repro.configs import FedConfig as JaxFedConfig  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import batch_iterator as jax_batch_iterator  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import FedConfig, get_arch  # noqa: E402
from repro_torch.data import batch_iterator  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def main(names):
    torch.set_num_threads(4)
    label_arrays, label_test = chip_smoke.quickstart_data()
    data = {"label-skew": (label_arrays, (label_test.images,
                                          label_test.labels)),
            "domain-shift": chip_smoke.domain_shift_data()}
    jm = jax_build_model(jax_get_arch("paper-cnn"))
    tm = build_model(get_arch("paper-cnn"), device="cpu")
    for family, strategy, fields in chip_smoke.TABLE1_RUNS:
        if names and strategy not in names:
            continue
        arrays, (x, y) = data[family]
        jx, jy = jnp.asarray(x), jnp.asarray(y)
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        jax_acc = jax.jit(lambda p: jnp.mean(
            jnp.argmax(jm.forward(p, {"images": jx}), -1) == jy))

        def torch_acc(p):
            with torch.no_grad():
                return float((tm.forward(p, {"images": tx}).argmax(-1)
                              == ty).float().mean())

        for name, pkg, model, fed, stream, acc in (
                ("jax", J, jm, JaxFedConfig, jax_batch_iterator, jax_acc),
                ("torch", T, tm, FedConfig, batch_iterator, torch_acc)):
            kw = {} if pkg is J else {"seed": 0}
            skw = {} if pkg is J else {"device": "cpu"}
            t0 = time.time()
            res = pkg.launch(pkg.Experiment(
                model=model, fed=fed(**chip_smoke.TABLE1_FED),
                strategy=strategy, eval_fn=acc,
                client_iters=[stream(a, 64, seed=i, **skw)
                              for i, a in enumerate(arrays)],
                **fields, **kw))
            print(f"{family:12s} {strategy:16s} {name:5s} final accuracy "
                  f"{float(res.final_metric):.4f} ({time.time() - t0:.0f} s "
                  "on the CPU)", flush=True)
    labels = label_test.labels
    shares = np.bincount(labels, minlength=10) / len(labels)
    print("label-skew test set, share of each class:", shares.tolist())


if __name__ == "__main__":
    main(sys.argv[1:])
