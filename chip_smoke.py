#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --planted-faults   # calibrate phase 5's checks

Needs one CUDA GPU (built for an H100: the kernels compile for sm_90a) and
the CUDA toolkit's nvcc. It imports nothing of JAX or of the JAX package.
Phases, each failing the run with a nonzero exit:

1. device  — the card's name and power limit; TF32 off for cuBLAS and cuDNN
2. build   — compile the path's kernel from the checkout's sources
3. kernels — the f32 GEMM kernel against its plain version at the shapes
             the paper CNN's training step gives it (forward, dA = G·Bᵀ,
             dB = Aᵀ·G) and one ragged shape; errors, times (L2 flushed
             before each launch), bounds
4. main    — paper Algorithm 1 through `launch(Experiment(strategy=
             "fedelmy"))` on the full-width paper CNN, with the launch
             counter showing every conv ran through the kernel
5. card vs CPU — each conv, one step (with the forward's decisions
             pinned) and a 5-step slice agree between the card (kernel)
             and the CPU (plain versions) from the same init
6. profile — where a training step's time goes (measured, not gated)

Before the last lines it prints every measurement as one JSON object on
a line starting "details: "; then the kernels' JSON record and the card's
nvidia-smi name and power limit; the last line is the result JSON.

``--planted-faults`` builds patched copies of the kernel, each with one
fault planted (PLANTED_FAULTS), and reads every check of phase 5 and the
f64 check of phase 3 with each, beside the correct kernel: which check
sees which fault, and where SLICE_RATIO_TOL lies between them.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the paper CNN's three convs at batch 64: (name, M, K, N, needs dA)
MAIN_SHAPES = [("c1", 64 * 32 * 32, 27, 64, False),
               ("c2", 64 * 16 * 16, 576, 128, True),
               ("c3", 64 * 8 * 8, 1152, 256, True)]
RAGGED_SHAPE = ("ragged", 1000, 77, 45, True)
GEMM_LAUNCHES_PER_STEP = 8     # c1: fwd + dB; c2, c3: fwd + dA + dB
CONVS = ("c1", "c2", "c3")
CARD = "cuda"
# phase 5 (c): the slice's end points may lie at most this share of the
# distance moved apart. `--planted-faults` read 0.0653 for the correct
# kernel and 0.125, 0.178 and 1.16 for the planted faults (H100, PERF.md).
SLICE_RATIO_TOL = 0.1


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def median_ms(fn, reps=25, warmup=3):
    """Median of per-launch CUDA-event times. L2 is flushed before each
    launch (a 256 MiB write; the H100's L2 holds 50 MB), so every launch
    reads its operands from HBM, as the byte bound assumes."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_parts_s(m, k, n):
    """(byte time, FLOP time) of one (M,K)@(K,N) f32 product: each input
    read once and the output written once; 2·M·N·K FLOP."""
    return ((m * k + k * n + m * n) * 4 / PEAK_BYTES,
            2 * m * n * k / PEAK_F32_FLOPS)


# ---------------------------------------------------------------------------
# phase 3: the GEMM kernel against its plain version
# ---------------------------------------------------------------------------

def check_gemm(torch, local_step, ref):
    """Every product of one training step's convs, plus a ragged shape.
    Tolerance: the kernel is within K·2⁻²³·(|A|·|B|) of the plain version
    elementwise — the worst-case difference of two f32 sums of K products
    taken in different orders — and within 1e-5 of the f64 product
    normwise (an f32 sum whose error grows like K·2⁻²⁴ fails that at the
    main path's K). Times: kernel, plain version and `torch.matmul` (the
    library yardstick; the port never calls it)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, max_abs = [], 0.0
    for name, m, k, n, needs_da in MAIN_SHAPES + [RAGGED_SHAPE]:
        a = torch.randn(m, k, device="cuda", generator=gen)
        b = torch.randn(k, n, device="cuda", generator=gen)
        g = torch.randn(m, n, device="cuda", generator=gen)
        products = [("fwd", (a, b, False, False), lambda: ref.gemm_ref(a, b),
                     lambda: torch.matmul(a, b), (m, k, n))]
        if needs_da:
            products.append(("dA", (g, b, False, True),
                             lambda: ref.gemm_ref(g, b.t()),
                             lambda: torch.matmul(g, b.t()), (m, n, k)))
        products.append(("dB", (a, g, True, False),
                         lambda: ref.gemm_ref(a.t(), g),
                         lambda: torch.matmul(a.t(), g), (k, m, n)))
        for prod, (x, y, ta, tb), plain, library, (pm, pk, pn) in products:
            def kernel(x=x, y=y, ta=ta, tb=tb):
                return local_step.gemm_f32(x, y, trans_a=ta, trans_b=tb)
            out = kernel()
            torch.cuda.synchronize()
            want = plain()
            xa = (x.t() if ta else x).double()
            yb = (y.t() if tb else y).double()
            bound = pk * 2.0 ** -23 * (xa.abs() @ yb.abs())
            err = (out.double() - want.double()).abs()
            ok = bool((err <= bound).all())
            abs_err = float(err.max())
            rel_err = abs_err / max(float(want.abs().max()), 1e-30)
            truth = xa @ yb
            nrm = float(truth.norm())
            f64_err = float((out.double() - truth).norm()) / nrm
            plain_f64_err = float((want.double() - truth).norm()) / nrm
            ok = ok and f64_err <= 1e-5
            byte_s, flop_s = bound_parts_s(pm, pk, pn)
            row = dict(conv=name, product=prod, m=pm, k=pk, n=pn,
                       max_abs_err=abs_err, max_rel_err=rel_err,
                       f64_err=f64_err, plain_f64_err=plain_f64_err,
                       within_tolerance=ok,
                       ms=median_ms(kernel), plain_ms=median_ms(plain),
                       library_ms=median_ms(library),
                       bound_ms=max(byte_s, flop_s) * 1e3,
                       bound_by="bytes" if byte_s >= flop_s else "operations",
                       main_path=name != "ragged")
            print(f"  gemm {name:6s} {prod:3s} ({pm}x{pk})@({pk}x{pn}): "
                  f"vs plain max abs err {abs_err:.3e} (rel {rel_err:.3e}); "
                  f"normwise err vs f64: kernel {f64_err:.2e}, plain "
                  f"{plain_f64_err:.2e}; {'within' if ok else 'OUTSIDE'} "
                  f"tolerance; "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                  f" ms, torch.matmul {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            if not ok:
                fail(f"gemm_f32 {name} {prod} disagrees with its plain "
                     f"version beyond the stated bound")
            max_abs = max(max_abs, abs_err)
            rows.append(row)
    return rows, max_abs


# ---------------------------------------------------------------------------
# phase 4 / 5 helpers
# ---------------------------------------------------------------------------

def quickstart_data():
    from repro_torch.data import dirichlet_partition, make_image_dataset
    train = make_image_dataset(n_samples=4000, seed=0, noise=2.5)
    test = make_image_dataset(n_samples=1000, seed=7, noise=2.5)
    parts = dirichlet_partition(train.labels, 4, 0.3, seed=0)
    arrays = [{"images": train.images[p], "labels": train.labels[p]}
              for p in parts]
    return arrays, test


def run_main_path(torch, local_step):
    from repro_torch.api import Experiment, launch
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.data import batch_iterator
    from repro_torch.models import build_model

    arrays, test = quickstart_data()
    model = build_model(get_arch("paper-cnn"))          # the CUDA device
    iters = [batch_iterator(a, 64, seed=i) for i, a in enumerate(arrays)]
    test_images = torch.from_numpy(test.images).to(model.device)
    test_labels = torch.from_numpy(test.labels).to(model.device)

    def accuracy(params):
        with torch.no_grad():
            logits = model.forward(params, {"images": test_images})
        return (logits.argmax(-1) == test_labels).float().mean()

    fed = FedConfig(n_clients=4, pool_size=3, e_local=25, e_warmup=10,
                    learning_rate=1e-3, alpha=0.06, beta=1.0)
    n_steps = fed.e_warmup + fed.n_clients * fed.pool_size * fed.e_local
    local_step.gemm_f32.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = launch(Experiment(model=model, client_iters=iters, fed=fed,
                            strategy="fedelmy", seed=0, eval_fn=accuracy))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = local_step.gemm_f32.launches

    for c in res.clients:
        losses = ", ".join(f"{m.task_loss:.4f}" for m in c.models)
        print(f"  client {c.client} (rank {c.rank}): global acc "
              f"{c.global_metric:.4f}; pool-model task losses [{losses}]")
    print(f"  final accuracy {res.final_metric:.4f}; {n_steps} steps in "
          f"{wall:.3f} s wall ({n_steps / wall:.2f} steps/s, 4 evals "
          f"included); gemm_f32 launches {launches}")
    if launches != GEMM_LAUNCHES_PER_STEP * n_steps:
        fail(f"gemm_f32 launched {launches} times in the main path; "
             f"expected {GEMM_LAUNCHES_PER_STEP} x {n_steps} steps")
    if len(res.clients) != 4 or any(len(c.models) != 3
                                    for c in res.clients):
        fail("the run's records do not have 4 clients x 3 pool models")
    if res.final_pool is None or res.final_pool.count != 4:
        fail("the final pool does not hold S+1 = 4 members")
    for k, v in res.params.items():
        if v.device.type != model.device.type or \
                not bool(torch.isfinite(v).all()):
            fail(f"final parameter {k} is not a finite tensor on the card")
    if not all(torch.isfinite(torch.tensor(m.task_loss))
               for c in res.clients for m in c.models):
        fail("a pool model's task loss is not finite")
    if not res.final_metric > 0.5:
        fail(f"final accuracy {res.final_metric:.4f} is not above 0.5 "
             f"(chance is 0.1): the run did not learn")
    return dict(steps=n_steps, wall_s=wall, steps_per_s=n_steps / wall,
                launches=launches, final_accuracy=res.final_metric,
                client_accuracy=[c.global_metric for c in res.clients])


# ---------------------------------------------------------------------------
# phase 5: the card (kernel) against the CPU (plain versions)
# ---------------------------------------------------------------------------

def _rel(a, b):
    """Normwise relative difference of `a` (any device) from CPU `b`."""
    return float((a.cpu() - b).norm()) / max(float(b.norm()), 1e-30)


def _windows(y):
    """(B, H, W, C) → (B, H/2, W/2, C, 4): the 2×2 max-pool windows."""
    b, h, w, c = y.shape
    return y.reshape(b, h // 2, 2, w // 2, 2, c).permute(
        0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, c, 4)


def cnn_decisions(torch, params, images):
    """The discontinuous decisions of the CNN's training forward (im2col +
    GEMM) on one batch: per conv, the ReLU signs, each pooling window's
    argmax and whether the window's max is positive (only those carry
    gradient); fc1's ReLU signs."""
    import torch.nn.functional as F

    from repro_torch.kernels.local_step import conv2d_gemm, maxpool2x2
    out = {}
    with torch.no_grad():
        x = images.float()
        for name in CONVS:
            y = conv2d_gemm(x, params[f"{name}.w"], params[f"{name}.b"])
            win = _windows(F.relu(y))
            out[name] = (y > 0, win.argmax(-1), win.amax(-1) > 0)
            x = maxpool2x2(F.relu(y))
        h = x.reshape(x.shape[0], -1) @ params["fc1.w"] + params["fc1.b"]
        out["fc1"] = (h > 0,)
    return out


def count_flips(card, cpu):
    """Decisions that differ between the card's and the CPU's forward:
    ReLU signs, and argmaxes of windows that carry gradient."""
    flips = {}
    for name, cpu_dec in cpu.items():
        n = int((card[name][0].cpu() != cpu_dec[0]).sum())
        if len(cpu_dec) > 1:
            n += int(((card[name][1].cpu() != cpu_dec[1]) & cpu_dec[2]).sum())
        flips[name] = n
    return flips


def pinned_loss(torch, decisions):
    """The CNN's training loss with its decisions fixed to `decisions`:
    ReLU as a product with the given signs, max-pool as a gather of the
    given argmax. Where the decisions are the input's own it computes the
    model's fused loss; with one device's decisions on both devices the
    two compute one continuous function of the parameters."""
    import torch.nn.functional as F

    from repro_torch.kernels.local_step import conv2d_gemm

    def loss(params, batch):
        x = batch["images"].float()
        for name in CONVS:
            signs, argmax, _ = decisions[name]
            y = conv2d_gemm(x, params[f"{name}.w"], params[f"{name}.b"])
            x = torch.gather(_windows(y * signs), -1,
                             argmax.unsqueeze(-1)).squeeze(-1)
        h = x.reshape(x.shape[0], -1) @ params["fc1.w"] + params["fc1.b"]
        logits = (h * decisions["fc1"][0]) @ params["fc2.w"] + \
            params["fc2.b"]
        return F.cross_entropy(logits, batch["labels"].long())

    return loss


def agreement_setup(torch):
    """Models on both devices, an init, a second pool member and one
    batch of client 0 on each device."""
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.data import batch_iterator
    from repro_torch.models import build_model

    arrays, _ = quickstart_data()
    models = {d: build_model(get_arch("paper-cnn"), device=d)
              for d in (CARD, "cpu")}
    return dict(
        arrays=arrays, models=models,
        fed=FedConfig(n_clients=2, pool_size=2, e_local=1, e_warmup=1,
                      learning_rate=1e-3),
        init=models["cpu"].init(1), member=models["cpu"].init(2),
        batches={d: next(batch_iterator(arrays[0], 64, seed=0, device=d))
                 for d in models})


def conv_agreement(torch, env):
    """(a) Each conv at the main path's shapes on the real activations of
    one batch: output and every gradient, card against CPU, normwise.
    Returns (error per conv, decisions flipped per conv)."""
    import torch.nn.functional as F

    from repro_torch.kernels.local_step import conv2d_gemm, maxpool2x2

    x = env["batches"]["cpu"]["images"]
    gen = torch.Generator().manual_seed(0)
    conv_err, flips = {}, {}
    for name in CONVS:
        w, b = env["init"][f"{name}.w"], env["init"][f"{name}.b"]
        g = torch.randn(x.shape[:3] + (w.shape[-1],), generator=gen)
        res = {}
        for dev in env["models"]:
            ins = [t.to(dev).clone().requires_grad_(name != "c1" or i > 0)
                   for i, t in enumerate((x, w, b))]
            y = conv2d_gemm(*ins)
            needs = [t for t in ins if t.requires_grad]
            res[dev] = [y.detach()] + list(torch.autograd.grad(
                y, needs, g.to(dev)))
        conv_err[name] = max(_rel(c, p) for c, p in zip(res[CARD],
                                                        res["cpu"]))
        dec = {}
        for dev in env["models"]:
            win = _windows(F.relu(res[dev][0]))
            dec[dev] = {name: (res[dev][0] > 0, win.argmax(-1),
                               win.amax(-1) > 0)}
        flips[name] = count_flips(dec[CARD], dec["cpu"])[name]
        x = maxpool2x2(F.relu(res["cpu"][0]))
    return conv_err, flips


def step_agreement(torch, env):
    """(b) One Eq. 9 step's gradients, card against CPU, normwise per
    leaf: through the model's own loss, and through `pinned_loss` with
    the CPU forward's decisions on both devices. Also the pinned loss
    against the model's loss on the CPU (it must compute the same step)."""
    from repro_torch.api.pools import backend_for
    from repro_torch.api.trainer import regularized_loss
    from repro_torch.kernels.local_step import fused_loss_for

    fed = env["fed"]
    backend = backend_for(fed)
    params = {d: {k: v.to(d) for k, v in env["init"].items()}
              for d in env["models"]}
    decisions = {d: cnn_decisions(torch, params[d],
                                  env["batches"][d]["images"])
                 for d in env["models"]}

    def grads(loss_fn, dev):
        pool = backend.create(params[dev], fed).append(
            {k: v.to(dev) for k, v in env["member"].items()})
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params[dev].items()}
        total, _ = regularized_loss(loss_fn, fed, backend)(
            leaves, env["batches"][dev], pool)
        return dict(zip(leaves, torch.autograd.grad(
            total, list(leaves.values()))))

    model = {d: grads(fused_loss_for(m.loss_fn), d)
             for d, m in env["models"].items()}
    pinned = {d: grads(pinned_loss(torch, {
        k: tuple(t.to(d) for t in v) for k, v in decisions["cpu"].items()}),
        d) for d in env["models"]}
    return dict(
        flips=count_flips(decisions[CARD], decisions["cpu"]),
        model={k: _rel(model[CARD][k], g) for k, g in model["cpu"].items()},
        pinned={k: _rel(pinned[CARD][k], g)
                for k, g in pinned["cpu"].items()},
        replica={k: _rel(pinned["cpu"][k], g)
                 for k, g in model["cpu"].items()})


def run_slice(torch, env, dev):
    """The slice for a few steps on `dev` from the setup's init."""
    from repro_torch.api import Experiment, launch
    from repro_torch.data import batch_iterator

    iters = [batch_iterator(a, 64, seed=i, device=dev)
             for i, a in enumerate(env["arrays"][:2])]
    return launch(Experiment(
        model=env["models"][dev], client_iters=iters, fed=env["fed"],
        strategy="fedelmy",
        init_params={k: v.to(dev) for k, v in env["init"].items()}))


def slice_agreement(torch, env, cpu_result):
    """(c) The slice on the card against `cpu_result`: the largest
    relative difference of a pool model's task loss, and how far apart
    the end points are over how far the CPU run moved."""
    card = run_slice(torch, env, CARD)
    losses = [[m.task_loss for c in r.clients for m in c.models]
              for r in (card, cpu_result)]
    apart = sum(float((card.params[k].cpu() - v).square().sum())
                for k, v in cpu_result.params.items()) ** 0.5
    moved = sum(float((v - env["init"][k]).square().sum())
                for k, v in cpu_result.params.items()) ** 0.5
    return dict(losses=losses, apart=apart, moved=moved,
                ratio=apart / moved,
                loss_rel=max(abs(a - b) / abs(b)
                             for a, b in zip(*losses)))


def card_vs_cpu(torch):
    """The card (kernel) against the CPU (plain versions) from the same
    init and batches. TF32 is off for cuBLAS and cuDNN.

    (a) Each conv at the main path's shapes on real activations: output
        and every gradient within 1e-5 normwise (f32 sums of up to
        65,536 terms in another order).
    (b) One Eq. 9 step's gradients, each leaf within 1e-5 normwise, with
        the forward's decisions (ReLU signs, max-pool argmax) pinned to
        the CPU's on both devices, so that both compute one continuous
        function. The pinned loss must match the model's on the CPU
        (1e-5 too). Through the model's own loss the step is held to 1e-5 as
        well when no decision flipped between the two forwards; a flip at
        a near-tie moves a whole gradient term, so with flips it is held
        to 1e-2 and the flips are printed.
    (c) A 5-step slice: every pool model's task loss within rtol 1e-2 and
        the end points apart by at most SLICE_RATIO_TOL of the distance
        the CPU run moved. Each pool model restarts Adam, whose first
        update is ≈ g/|g|: a near-zero gradient whose sign a flip changes
        moves a whole learning rate, so two correct f32 paths drift
        apart. SLICE_RATIO_TOL lies between the correct kernel's reading
        and a planted fault's (`--planted-faults`, PERF.md)."""
    env = agreement_setup(torch)

    conv_err, conv_flips = conv_agreement(torch, env)
    print("  (a) each conv, output and gradients, normwise error: " +
          ", ".join(f"{k} {v:.2e}" for k, v in conv_err.items()) +
          " (tolerance 1e-5); decisions flipped between card and CPU "
          "outputs (ReLU sign, max-pool argmax): " +
          ", ".join(f"{k} {v}" for k, v in conv_flips.items()))
    if max(conv_err.values()) > 1e-5:
        fail("a conv's card and CPU outputs or gradients disagree")

    step = step_agreement(torch, env)
    n_flips = sum(step["flips"].values())
    model_tol = 1e-5 if n_flips == 0 else 1e-2
    worst = {k: max(step[k].values())
             for k in ("model", "pinned", "replica")}
    print("  (b) one step's gradients, normwise error per leaf; decisions "
          "pinned to the CPU's: " +
          ", ".join(f"{k} {v:.1e}" for k, v in step["pinned"].items()) +
          f"; worst {worst['pinned']:.3e} (tolerance 1e-5)")
    print(f"      pinned loss against the model's loss on the CPU: worst "
          f"{worst['replica']:.3e} (tolerance 1e-5)")
    print(f"      through the model's loss: worst {worst['model']:.3e} "
          f"with {n_flips} decisions flipped ({step['flips']}; tolerance "
          f"{model_tol:g})")
    if worst["pinned"] > 1e-5 or worst["replica"] > 1e-5:
        fail("card and CPU gradients of the step disagree with the "
             "decisions pinned")
    if worst["model"] > model_tol:
        fail("card and CPU gradients of the step disagree")

    cpu_result = run_slice(torch, env, "cpu")
    sl = slice_agreement(torch, env, cpu_result)
    fed = env["fed"]
    n_steps = fed.e_warmup + fed.n_clients * fed.pool_size * fed.e_local
    print(f"  (c) {n_steps} steps: task losses card {sl['losses'][0]} cpu "
          f"{sl['losses'][1]}, max rel diff {sl['loss_rel']:.3e} "
          f"(tolerance 1e-2); end points {sl['apart']:.4e} apart after "
          f"moving {sl['moved']:.4e}: ratio {sl['ratio']:.3e} (tolerance "
          f"{SLICE_RATIO_TOL})")
    if sl["loss_rel"] > 1e-2 or sl["ratio"] > SLICE_RATIO_TOL:
        fail("card and CPU runs of the slice disagree")
    sl.pop("losses")
    return dict(conv_err=conv_err, conv_decision_flips=conv_flips,
                step=step, step_decision_flips=n_flips, slice=sl,
                slice_steps=n_steps)


# Faults planted in csrc/gemm_f32.cu for `--planted-faults`: (name, text
# in the source, its replacement).
PLANTED_FAULTS = [
    ("first_k_chunk_x1.001", "acc[i][j] += part[i][j];",
     "acc[i][j] += (k0 < CHUNK_K ? 1.001f : 1.f) * part[i][j];"),
    ("first_k_chunk_x1.01", "acc[i][j] += part[i][j];",
     "acc[i][j] += (k0 < CHUNK_K ? 1.01f : 1.f) * part[i][j];"),
    ("ragged_k_chunk_dropped",
     "if ((k0 + BK) % CHUNK_K == 0 || k0 + BK >= K) {",
     "if ((k0 + BK) % CHUNK_K == 0) {"),
]


def planted_faults(torch, local_step):
    """Read every check of phases 3 and 5 with the correct kernel and
    with each planted fault in its place (built from a patched copy of
    the source in the git-ignored build directory). Gates nothing: it
    shows which check sees which fault, and where SLICE_RATIO_TOL lies."""
    import ctypes

    from repro_torch.kernels import build
    env = agreement_setup(torch)
    cpu_result = run_slice(torch, env, "cpu")
    source = (build.CSRC / "gemm_f32.cu").read_text()
    readings = {}
    for name, old, new in [("none", "", "")] + PLANTED_FAULTS:
        if name == "none":
            lib = local_step._gemm_lib()
        else:
            if source.count(old) != 1:
                fail(f"planted fault {name}: its anchor text is not in "
                     "csrc/gemm_f32.cu once")
            path = build.BUILD_DIR / "planted" / f"gemm_f32_{name}.cu"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(source.replace(old, new))
            build.build_source(path)
            lib = local_step.bind_gemm(
                ctypes.CDLL(str(build.library_path(path))))
        local_step._gemm_lib = lambda lib=lib: lib
        gen = torch.Generator(device="cuda").manual_seed(0)
        f64_err = 0.0
        for _, m, k, n, _ in MAIN_SHAPES:
            a = torch.randn(m, k, device="cuda", generator=gen)
            b = torch.randn(k, n, device="cuda", generator=gen)
            truth = a.double() @ b.double()
            f64_err = max(f64_err, float(
                (local_step.gemm_f32(a, b).double() - truth).norm() /
                truth.norm()))
        conv_err, _ = conv_agreement(torch, env)
        step = step_agreement(torch, env)
        sl = slice_agreement(torch, env, cpu_result)
        readings[name] = dict(
            gemm_fwd_f64_err=f64_err, conv_err=max(conv_err.values()),
            step_pinned=max(step["pinned"].values()),
            step_model=max(step["model"].values()),
            step_flips=sum(step["flips"].values()),
            slice_loss_rel=sl["loss_rel"], slice_ratio=sl["ratio"])
        print(f"  {name:24s} " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in readings[name].items()))
    return readings


def profile_steps(torch, n_steps=20):
    """Where a training step's time goes: `torch.profiler` over
    `n_steps` Eq. 9 steps of the full-width CNN at batch 64 (after 3
    warm-up steps): host time per step, device busy time per step (the
    kernels' summed device time), the device's idle share, kernels
    launched per step and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api.trainer import LocalTrainer
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.data import batch_iterator
    from repro_torch.models import build_model

    arrays, _ = quickstart_data()
    model = build_model(get_arch("paper-cnn"))
    fed = FedConfig(n_clients=4, pool_size=3, e_local=25, e_warmup=10,
                    learning_rate=1e-3)
    trainer = LocalTrainer(model.loss_fn, fed)
    params = model.init(3)
    pool = trainer.backend.create(params, fed).append(model.init(4))
    it = batch_iterator(arrays[0], 64, seed=0)
    trainer.train(pool.average(), it, 3, pool=pool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(pool.average(), it, n_steps, pool=pool)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = dict(steps=n_steps, host_ms_per_step=host_s * 1e3 / n_steps,
               device_busy_ms_per_step=busy_us / 1e3 / n_steps,
               idle_share=1.0 - busy_us / 1e6 / host_s if host_s else None,
               kernels_per_step=len(kernels) / n_steps,
               top=[(name, us / 1e3 / n_steps) for name, us in top])
    print(f"  {out['host_ms_per_step']:.3f} ms/step on the host clock "
          f"(profiler on), device busy {out['device_busy_ms_per_step']:.3f}"
          f" ms/step, idle share {out['idle_share']:.3f}, "
          f"{out['kernels_per_step']:.1f} kernels/step")
    for name, ms in out["top"]:
        print(f"    {ms:8.4f} ms/step  {name[:90]}")
    return out


def main(argv):
    """No arguments: every phase. ``--planted-faults``: phases 1-2, then
    `planted_faults` (a calibration of phase 5's checks; no result line)."""
    if argv not in ([], ["--planted-faults"]):
        fail(f"unknown arguments {argv}; the only option is "
             "--planted-faults")
    planted = argv == ["--planted-faults"]
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA GPU")
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's package is missing: no {SRC / 'repro_torch'}")
    sys.path.insert(0, str(SRC))

    # phase 1: device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1] device: {torch.cuda.get_device_name(0)} ({smi_line}); "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # phase 2: build the path's kernel
    from repro_torch.kernels import build, local_step, ref
    t0 = time.perf_counter()
    log = build.build("gemm_f32")
    build_s = time.perf_counter() - t0
    print(f"[2] build: {build_s:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  gemm_f32: {line.strip()}")

    if planted:
        print("[5] every agreement check with each planted fault")
        readings = planted_faults(torch, local_step)
        print("planted: " + json.dumps(readings))
        print(smi_line)
        return

    # phase 3: kernel against plain version
    print("[3] gemm_f32 against its plain version (TF32 off)")
    rows, max_abs = check_gemm(torch, local_step, ref)

    # phase 4: the main path
    print("[4] main path: launch(Experiment(strategy='fedelmy')), "
          "full-width paper CNN")
    main_path = run_main_path(torch, local_step)

    # phase 5: card against CPU
    print("[5] card (kernel) against CPU (plain versions)")
    agreement = card_vs_cpu(torch)

    # phase 6: where a step's time goes (a measurement, not a gate)
    print("[6] profile of the training step")
    step_profile = profile_steps(torch)

    step_rows = [r for r in rows if r["main_path"]]
    byte_s = sum(bound_parts_s(r["m"], r["k"], r["n"])[0] for r in step_rows)
    flop_s = sum(bound_parts_s(r["m"], r["k"], r["n"])[1] for r in step_rows)
    kernels = {"kernels": [{
        "name": "gemm_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm_f32.cu",
        "replaces": "src/repro/kernels/local_step.py:113",
        "launches": main_path["launches"],
        "max_abs_err": max_abs,
        # the 8 products of one training step at batch 64, summed
        "ms": sum(r["ms"] for r in step_rows),
        "plain_ms": sum(r["plain_ms"] for r in step_rows),
        "bound_ms": max(byte_s, flop_s) * 1e3,
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
        "library_ms": sum(r["library_ms"] for r in step_rows)}]}
    print("details: " + json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi_line,
        build_s=build_s, gemm=rows, main_path=main_path,
        card_vs_cpu=agreement, profile=step_profile,
        total_s=time.perf_counter() - t_start)))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
