"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with `ctypes`;
`build_all` starts one compiler per source, all together. The build
happens at first use, from the package's own sources, into ``build/``
beside this file (git-ignored); the library's file name carries a hash of
its source, so an edited source never loads a stale build. Nothing here
runs at import time."""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Callable, Dict, Sequence

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
# -split-compile=0: the device optimizer's passes on every host thread,
# which shortens the largest sources' builds (flash_attn_f32.cu's most)
# and leaves every kernel's registers and spills as they were
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_sources(sources: Sequence[Path]) -> Dict[str, str]:
    """Compile every source not built yet, one `nvcc` each, all started
    together; returns each source's compiler output by stem (``-Xptxas
    -v`` register and shared-memory report; empty for a library already
    built). Raises with the output of every nvcc that failed."""
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[source] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {source.stem: "" for source in sources}
    failed = []
    for source, (tmp, proc) in procs.items():
        logs[source.stem] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source.name} (exit "
                          f"{proc.returncode}):\n{logs[source.stem]}")
        else:
            os.replace(tmp, library_path(source))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_source(source: Path) -> str:
    """Compile `source` unless built already (see `build_sources`)."""
    return build_sources([source])[source.stem]


def build(name: str) -> str:
    """Compile kernel ``csrc/<name>.cu`` if needed (see `build_sources`)."""
    return build_source(CSRC / f"{name}.cu")


def build_all() -> Dict[str, str]:
    """Compile every kernel of ``csrc/`` that is not built yet, in
    parallel (see `build_sources`)."""
    return build_sources(sorted(CSRC.glob("*.cu")))


_counter_buffers: Dict[Any, Any] = {}


def counters(device, stream: int, size: int):
    """`size` int32 counters for the kernels that find a group's last
    block with an integer atomic (the GEMM's split tiles, BGMV's row
    blocks, the GLA's heads), one buffer per (device, stream, size),
    zeroed once here: each group's last block sets its counter back to 0,
    so a call launches nothing but its kernels. Keyed by stream, so that
    calls on two streams never share a counter. A buffer is made outside
    any CUDA graph capture (a step is run once on the capturing stream
    before it is captured); asked for the first time during a capture,
    this raises."""
    import torch
    key = (torch.device(device), stream, size)
    if key not in _counter_buffers:
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "build.counters: no counter buffer for this stream yet; run "
                "the step once on the capturing stream before capturing it")
        _counter_buffers[key] = torch.zeros(size, device=device,
                                            dtype=torch.int32)
    return _counter_buffers[key]


def refuse_vmapped(name: str, *tensors) -> None:
    """Raise where a kernel's launcher is handed a tensor that a
    `torch.func` transform wraps (`vmap`'s batched run axis): a ctypes
    launch cannot read it, and a launcher reached that way has no vmap
    rule, so batched execution through its kernel is not ported yet. The
    GEMM's and the sweep's autograd Functions have vmap rules that hand
    their launchers the run-stacked tensors instead."""
    import torch
    from torch._C._functorch import is_functorch_wrapped_tensor
    if any(isinstance(t, torch.Tensor) and is_functorch_wrapped_tensor(t)
           for t in tensors):
        raise NotImplementedError(
            f"{name}: reached under torch.func.vmap; this kernel has no "
            "vmap rule, so batched execution through it is not ported yet")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(CSRC / f"{name}.cu")))


# launches counted while a CUDA graph was being captured, by wrapper
_captured: Dict[Callable, int] = {}


def count_launches(wrapper: Callable, n: int = 1) -> None:
    """Count `n` launches of a kernel wrapper in its ``launches``
    attribute — or, while the current stream is being captured into a
    CUDA graph (where nothing runs yet), in the capture's tally, which
    `capture_counts` hands to the graph: each replay then adds them
    (`add_replays`)."""
    import torch
    if torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing():
        _captured[wrapper] = _captured.get(wrapper, 0) + n
    else:
        wrapper.launches += n


@contextlib.contextmanager
def capture_counts():
    """Around a graph capture: yields a dict, filled on exit with the
    launches each wrapper made in the capture (the launches one replay
    makes)."""
    _captured.clear()
    counts: Dict[Callable, int] = {}
    try:
        yield counts
    finally:
        counts.update(_captured)
        _captured.clear()


def capture_graph(body: Callable[[], Any], pool: Any = None):
    """Capture `body()` into a new CUDA graph on the current stream (a
    side stream, where a warm-up run of the body went first); returns the
    graph, the launches one replay makes (`capture_counts`) and what the
    body returned. `pool`, another graph's `pool()`, makes the new graph
    allocate from that graph's memory pool: for graphs that never run at
    once and leave nothing alive that the other reads. The cycle
    collector is off during the capture: an object it freed there
    (another graph, a pinned buffer) would call the CUDA runtime outside
    the captured stream and void the capture.
    (`torch.cuda.graph` would also empty the allocator's caches first,
    which costs later allocations more than the capture saves.) A capture
    that fails raises."""
    import gc

    import torch
    graph = torch.cuda.CUDAGraph()
    was_on = gc.isenabled()
    gc.disable()
    try:
        with capture_counts() as counts:
            if pool is None:
                graph.capture_begin()
            else:
                graph.capture_begin(pool=pool)
            try:
                out = body()
            finally:
                graph.capture_end()
    finally:
        if was_on:
            gc.enable()
    return graph, counts, out


def add_replays(counts: Dict[Callable, Any], replays: int = 1) -> None:
    """Count `replays` replays of a graph whose capture made `counts`."""
    for wrapper, n in counts.items():
        wrapper.launches += n * replays


@contextlib.contextmanager
def side_stream(holder: Any, device: Any = None):
    """Run the body on `holder.stream`, the side stream a capture needs
    (made at first use on `device`), after the current stream's work; the
    work is handed back to the current stream on exit."""
    import torch
    if holder.stream is None:
        holder.stream = torch.cuda.Stream(device)
    current = torch.cuda.current_stream(device)
    holder.stream.wait_stream(current)
    with torch.cuda.stream(holder.stream):
        yield
    current.wait_stream(holder.stream)


def graph_steps(captured: Any, body: Callable[[], Any], n: int = 1,
                pool: Any = None):
    """n > 0 steps of `body` on the side stream through one CUDA graph.
    `captured` is the (graph, counts) of an earlier call, or None: then
    the first step runs eagerly (a real step, which also makes every
    buffer a kernel wrapper keeps per stream) and the body is captured
    after it (`capture_graph`, into `pool` when given). The other steps
    are replays, counted in the wrappers (`add_replays`). Returns
    ((graph, counts), whether it captured, the replays made)."""
    fresh = captured is None
    if fresh:
        body()
        n -= 1
        graph, counts, _ = capture_graph(body, pool)
        captured = (graph, counts)
    graph, counts = captured
    for _ in range(n):
        graph.replay()
    add_replays(counts, n)
    return captured, fresh, n
