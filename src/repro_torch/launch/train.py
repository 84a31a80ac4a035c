"""Training launcher: FedELMY (or any registered strategy) on any
assigned architecture (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-cnn \
      --clients 4 --pool 3 --e-local 20 [--method fedseq|fedelmy|...]
      [--arch llama3.2-1b --seq-len 128]  # any language-model arch
      [--handoff-dir ckpt/handoff]    # serialize the final model
      [--device cpu]                 # default: the CUDA device

The paper CNN trains on label-skewed or domain-shifted images and is
scored by accuracy (`acc`). A language-model arch always trains at its
`reduced()` size, as the reference's CLI does (`--reduced` asks for it
for every arch but `paper-cnn`, which has none): one Markov domain of
`make_lm_dataset` a client, next-token labels, scored by the held-out
set's mean negative NLL (`-nll`). As in the reference, that held-out set
is drawn at seed + 77, from transition matrices no client trained on, so
its NLL cannot fall below chance (ln V). The encoder-decoder
(seamless-m4t-medium) raises: the reference's CLI cannot train it either,
its LM batch carrying no source (ROADMAP C22).

`--handoff-dir` writes the final params with `checkpoint.save_pytree`,
reads them back with `load_pytree` and checks the round trip bit for bit:
the transfer format between clients that run as separate processes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import List, Optional

import torch

from repro_torch.api import Experiment, launch, list_strategies
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import FedConfig, get_arch
from repro_torch.data import (DataPlan, dirichlet_partition,
                              domain_shift_partition, make_domain_datasets,
                              make_image_dataset, make_lm_dataset)
from repro_torch.device import resolve_device
from repro_torch.models import build_model, lm_eval_fn


def build_clients(args, cfg, device: torch.device):
    """Per-client DataPlans (seeds `seed·100 + i`) and the test batch on
    `device`, the reference's data for the same arguments."""
    if cfg.family == "cnn":
        if args.distribution == "label-skew":
            ds = make_image_dataset(args.samples, seed=args.seed, noise=2.5)
            parts = dirichlet_partition(ds.labels, args.clients,
                                        args.dirichlet_beta, seed=args.seed)
            clients = [{"images": ds.images[p], "labels": ds.labels[p]}
                       for p in parts]
        else:
            doms = make_domain_datasets(args.samples // 4, seed=args.seed)
            cs = domain_shift_partition(doms, args.clients)
            clients = [{"images": c.images, "labels": c.labels} for c in cs]
        held = make_image_dataset(args.samples // 4, seed=args.seed + 77,
                                  noise=2.5)
        test = {"images": held.images, "labels": held.labels}
    else:
        doms = make_lm_dataset(n_seqs=args.samples // 64 * 64 or 64,
                               seq_len=args.seq_len, vocab=cfg.vocab_size,
                               n_domains=args.clients, seed=args.seed)
        clients = [{"tokens": d.tokens[:, :-1], "labels": d.tokens[:, 1:]}
                   for d in doms]
        held = make_lm_dataset(n_seqs=64, seq_len=args.seq_len,
                               vocab=cfg.vocab_size, n_domains=1,
                               seed=args.seed + 77)[0]
        test = {"tokens": held.tokens[:64, :-1],
                "labels": held.tokens[:64, 1:]}
    test_batch = {k: torch.from_numpy(v).to(device) for k, v in test.items()}
    iters = [DataPlan(c, args.batch, seed=args.seed * 100 + i, device=device)
             for i, c in enumerate(clients)]
    return iters, test_batch


def make_eval(model, cfg, test_batch):
    """Accuracy for the CNN; the mean negative NLL for a language model
    (higher is better either way)."""
    if cfg.family != "cnn":
        return lm_eval_fn(model, test_batch)

    def acc(params):
        with torch.no_grad():
            logits = model.forward(params, test_batch)
        return (logits.argmax(-1) == test_batch["labels"]).float().mean()
    return acc


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-cnn")
    ap.add_argument("--method", default="fedelmy",
                    choices=list_strategies())
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--pool", type=int, default=3)
    ap.add_argument("--e-local", type=int, default=20)
    ap.add_argument("--e-warmup", type=int, default=10)
    ap.add_argument("--shots", type=int, default=1)
    ap.add_argument("--alpha", type=float, default=0.06)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale arch variant")
    ap.add_argument("--moment-form", action="store_true")
    ap.add_argument("--pool-backend", default=None,
                    help="pool representation: stacked | moment | lowrank "
                         "(default stacked; lowrank is the "
                         "transformer-scale factor pool)")
    ap.add_argument("--pool-rank", type=int, default=8,
                    help="rank ceiling for --pool-backend lowrank")
    ap.add_argument("--distribution", default="label-skew",
                    choices=["label-skew", "domain-shift"])
    ap.add_argument("--dirichlet-beta", type=float, default=0.5)
    ap.add_argument("--handoff-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if (args.reduced or cfg.family != "cnn") and args.arch != "paper-cnn":
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        raise ValueError(
            f"launch.train: --arch {args.arch} is an encoder-decoder, whose "
            "loss needs a source (src_embeds); the reference's CLI builds "
            "decoder-only LM batches {tokens, labels} and cannot train it "
            "either (repro/launch/train.py:53, repro/models/"
            "transformer.py:742-745; ROADMAP C22)")
    device = resolve_device(args.device)
    model = build_model(cfg, device=device)
    iters, test_batch = build_clients(args, cfg, device)
    eval_fn = make_eval(model, cfg, test_batch)
    metric = "acc" if cfg.family == "cnn" else "-nll"
    if metric == "-nll":
        print(f"held-out set: {test_batch['tokens'].shape[0]} sequences of "
              f"a Markov chain drawn at seed {args.seed + 77}, which none of "
              "the clients trained on: its NLL cannot fall below chance, "
              f"ln V = {math.log(cfg.vocab_size):.4f}")
    backend = args.pool_backend or (
        "moment" if args.moment_form else "stacked")
    fed = FedConfig(n_clients=args.clients, pool_size=args.pool,
                    e_local=args.e_local, e_warmup=args.e_warmup,
                    alpha=args.alpha, beta=args.beta,
                    learning_rate=args.lr,
                    pool_backend=backend, pool_rank=args.pool_rank,
                    distance_measure=("squared_l2" if backend == "moment"
                                      else "l2"),
                    seed=args.seed)

    t0 = time.time()
    method = args.method
    if method == "fedelmy" and args.shots > 1:
        method = "fedelmy_fewshot"
    track_eval = eval_fn if method.startswith("fedelmy") else None
    res = launch(Experiment(model=model, client_iters=iters, fed=fed,
                            strategy=method, seed=args.seed,
                            eval_fn=track_eval, shots=args.shots))
    m, hist = res.params, res.history()
    score = (res.final_metric if res.final_metric is not None
             else float(eval_fn(m)))
    wall = time.time() - t0

    if args.handoff_dir:          # the serialized transfer format
        path = os.path.join(args.handoff_dir, "m_final.npz")
        save_pytree(path, m)
        m2 = load_pytree(path, {k: torch.empty_like(v)
                                for k, v in m.items()})
        if not all(torch.equal(m[k], m2[k]) for k in m):
            raise RuntimeError(f"handoff checkpoint {path} does not read "
                               "back bit for bit")
        print(f"handoff checkpoint: {path} "
              f"({os.path.getsize(path) / 1e6:.1f} MB), read back bitwise")

    print(f"method={args.method} arch={args.arch} {metric}={score:.4f} "
          f"wall={wall:.1f}s")
    out = {"method": args.method, "arch": args.arch, metric: score,
           "wall_s": wall, "history": hist}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)
    return out


if __name__ == "__main__":
    main()
