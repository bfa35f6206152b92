"""Build, load and launch the hand-written CUDA kernels.

No counterpart in the JAX package (Pallas compiles inside ``pallas_call``).
On first use, a ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library of its own with a plain C interface, under
``nuts_rs_tpu_torch/_build/`` (named by a hash of the source, the headers
and the flags, so an edited source rebuilds), and loaded with ``ctypes``: a
caller builds only the kernels it launches, and :func:`build` starts one
``nvcc`` per source for several at once (:func:`start_build` in the
background, :func:`library` then waiting for its own source alone).  The
launchers
check every tensor, allocate outputs with ``torch.empty`` and launch on
PyTorch's current stream; a nonzero ``cudaGetLastError`` raises.

The kernels compile with ``-fmad=false`` and without fast math, so their
arithmetic stays within a few ulp of the plain PyTorch versions (one
rounding per operation, as PyTorch's elementwise kernels round).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..dynamics.hamiltonian import KineticKind

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# (d, maxdepth) instantiations of the chains-on-lanes NUTS kernels K1 / K2 (a
# chain's coordinates on a group of lanes, ``nuts_lanes``); every other size
# takes the mid-d kernels (``nuts_fused.cl_kernel``).  The MCLMC kernels are
# instantiated for the same d (``DIMS``), both kinetic energies and both
# settings of ``dynamic_step_size``.  The mid-d chains-on-lanes kernels, NUTS
# and MCLMC (above ``CL_THREAD_MAX_DIM``, and every model with data), and the
# dim-on-lanes (ld) NUTS kernels take d (and maxdepth) at run time.
SIZES = tuple((d, 10) for d in (3, 4, 6, 10))
DIMS = tuple(sorted({d for d, _ in SIZES}))
CL_THREAD_MAX_DIM = max(DIMS)
# nrt::ModelId of each kernel hook name (csrc/models.cuh)
MODEL_IDS = {"iid_normal": 0, "logistic_regression": 1,
             "logistic_regression_stream": 2, "correlated_normal_rank1": 3,
             "radon": 4, "stochastic_volatility": 5, "funnel": 6,
             "correlated_normal": 7}
# The functors with a one-coordinate form: the term / finish of the
# chains-on-lanes kernels K1-K4 and of the dim-on-lanes kernels K1-ld /
# K2-ld.  Every functor but the streamed one has the eval_block form, which
# the mid-d kernels and the dim-on-lanes kernels with data (ld_args)
# take.
COORD_FUNCTORS = frozenset({"iid_normal"})
# kernel launches that evaluated each functor, by hook name: the wrappers
# count them beside their kernels' launches (count_model)
MODEL_LAUNCHES = dict.fromkeys(MODEL_IDS, 0)
# launches of kernel K1-flow in each form of its flow (flow_form), counted
# beside the kernel's own count
FLOW_FORM_LAUNCHES = {"warp": 0, "today": 0}
MAX_BLOCK = 128  # nrt::MAX_BLOCK, the kernels' __launch_bounds__
# ld kernels: chains per logical block = CUDA blocks per cluster
# (nrt::LD_MAX_CLUSTER, the portable cluster size); live vectors a chain
# keeps in shared memory (nrt::LD_POST_NVEC / LD_WARM_NVEC) and the dynamic
# shared memory a block may opt in to on sm_90.
MAX_LD_BLOCK = 8
LD_NVEC = {"posterior": 21, "warmup": 18}
MID_NVEC = {"posterior": 21, "warmup": 19}  # the warmup keeps q1 as well
# mid-d kernels K1-args / K2-args: at most GROUP_MAX chains a CUDA block, a
# warp each (nrt::GR_MAX), in blocks of GROUP_FLAGS floats of flags; the
# regression's group form keeps its residuals in registers up to
# GROUP_ROWS_IN_REGISTERS rows (LogisticRegression::rows_in_registers)
GROUP_MAX = 8
GROUP_FLAGS = 2 * GROUP_MAX
GROUP_SCALARS = GROUP_MAX * 64  # nrt::GR_SCALAR_FLOATS a chain (group form)
GROUP_ROWS_IN_REGISTERS = 256 * 4
MCLMC_MID_NVEC = 15  # nrt::MC_MID_NVEC, both mid-d MCLMC kernels
LD_WARPS = 8  # nrt::LD_W, warps of a chain's block (ops.TSUM_THREADS / 32)
LD_REDUCE_FLOATS = 2 * 11 * LD_WARPS  # two scratch buffers, LD_NRED x LD_W
# K1-ld / K2-ld's merged leapfrog: the wide reduction's two scratch buffers,
# LD_W x LD_WIDE (csrc/block_sum.cuh::WideReducer), besides LD_REDUCE_FLOATS
LD_WIDE_FLOATS = 2 * LD_WARPS * 32
LD_MAX_MAXDEPTH = 30
# Shared memory of one SM on sm_90 (cudaDevAttrMaxSharedMemoryPerMultiprocessor)
# and what the card reserves for each resident block
# (cudaDevAttrReservedSharedMemoryPerBlock): one block may opt in to
# SM_SMEM_BYTES - SMEM_BLOCK_RESERVED bytes, and each of k blocks resident on
# one SM to at most SM_SMEM_BYTES // k - SMEM_BLOCK_RESERVED
# (stream_block_smem_limit; csrc/nuts_fused_stream_posterior.cu checks the
# same).
SM_SMEM_BYTES = 233472
SMEM_BLOCK_RESERVED = 1024
SMEM_OPT_IN_BYTES = SM_SMEM_BYTES - SMEM_BLOCK_RESERVED
H100_SMS = 132  # SMs of the card the kernels are sized for
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]
# Macros for timing ablations only (profile_main_path.py items 12-18;
# all but NRT_LD_ARGS_MIN_BLOCKS change results): NRT_ABLATE_FIXED_TREES
# (csrc/nuts_tree_ld.cuh), NRT_ABLATE_SV_SCANS, NRT_ABLATE_SV_BARRIERS
# (csrc/models.cuh), NRT_LD_ARGS_MIN_BLOCKS=n, NRT_LD_MIN_BLOCKS=n,
# NRT_LD_TODAY, NRT_LD_EARLY=n, NRT_LD_CLOCKS (csrc/nuts_tree_ld.cuh: K1-ld /
# K2-ld's blocks an SM, form, early loads and phase clocks; none of these
# four changes results), NRT_FLOW_CLOCKS, NRT_FLOW_NO_PASSES (changes
# results), NRT_FLOW_TODAY, NRT_FLOW_BARRIERS, NRT_FLOW_CONFLICTS,
# NRT_FLOW_ROLLED, NRT_FLOW_MIN_BLOCKS=n (csrc/coupling_flow.cuh and
# nuts_fused_flow_posterior.cuh: K1-flow's phase clocks, its flow's passes
# left out, its form, and the warp form with block barriers, with bank
# conflicts, with today's loops, its blocks an SM), NRT_ABLATE_EVAL
# (csrc/nuts_fused_mid_posterior.cu and the group-form MCLMC kernels: no
# model evaluation), NRT_ABLATE_FIXED_STEPS (csrc/mclmc_step_group.cuh: 6
# leapfrogs a draw, no halvings), NRT_MCLMC_LANES=n, NRT_ABLATE_MCLMC_NORMALS,
# NRT_ABLATE_MCLMC_DIVISIONS (csrc/mclmc_step.cuh: K3 / K4's lanes a chain,
# their normals without the hashes and Box-Muller, their ESH and refresh
# quotients by __fdividef; all change results but the lanes),
# NRT_NUTS_LANES=n, NRT_NUTS_MAX_THREADS=n, NRT_ABLATE_NUTS_NORMALS,
# NRT_NUTS_SMEM_STACKS (csrc/nuts_tree.cuh: K1 / K2's lanes a chain, their
# blocks' threads at most, their normals without the hashes and Box-Muller
# (changes results), their checkpoint stacks in shared memory),
# NRT_MCLMC_CLOCKS (csrc/block_sum.cuh: the block-form MCLMC kernels' SM
# cycles by phase; NRT_ABLATE_EVAL, NRT_ABLATE_MCLMC_NORMALS and
# NRT_ABLATE_MCLMC_DIVISIONS act there too; profile_main_path.py item 22).
# Empty in every other use; set before the first library loads.
NVCC_DEFINES = []

BUILD_INFO = {"seconds": 0.0, "libraries": {}, "nvcc_seconds": {}}
_LIBS = {}
# sources whose nvcc start_build started: an event set when it has ended, and
# nvcc's output where it failed
_BUILDING, _BUILD_FAILED = {}, {}
_BUILD_LOCK = threading.Lock()

_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
_LL = ctypes.c_longlong
_NUTS_POST = [_I, _I, _I, _I, _I, _U, _F, _I, _F, _F, _I]
_NUTS_WARM = _NUTS_POST + [_F] * 5 + [_I]
# K1 / K2 take the chain's lanes (nuts_lanes) after maxdepth
_NUTS_LANES_POST = _NUTS_POST[:2] + [_I] + _NUTS_POST[2:]
_NUTS_LANES_WARM = _NUTS_WARM[:2] + [_I] + _NUTS_WARM[2:]
_MCLMC_POST = [_I, _I, _I, _I, _I, _I, _U, _F, _F, _F, _F, _I, _F, _F, _I]
_MCLMC_WARM = [_I, _I, _I, _I, _I, _I, _U, _F, _F, _F, _F, _F, _I, _F, _F,
               _I, _I]
# K3 / K4 take the chain's lanes (mclmc_lanes) after dynamic_step_size
_LANES_POST = _MCLMC_POST[:3] + [_I] + _MCLMC_POST[3:]
_LANES_WARM = _MCLMC_WARM[:3] + [_I] + _MCLMC_WARM[3:]
# One shared library per source: stem -> {exported function: (argtypes,
# restype)}.
SOURCES = {
    "nuts_fused_posterior": {
        "nrt_posterior_launch": (_NUTS_LANES_POST + [_P] * 16, _I),
        "nrt_nuts_lanes": ([_I, _I], _I)},
    "nuts_fused_warmup": {
        "nrt_warmup_launch": (_NUTS_LANES_WARM + [_P] * 20, _I),
        "nrt_nuts_lanes": ([_I, _I], _I)},
    "mclmc_fused_posterior": {
        "nrt_mclmc_posterior_launch": (_LANES_POST + [_P] * 18, _I),
        "nrt_mclmc_lanes": ([_I, _I], _I)},
    "mclmc_fused_warmup": {
        "nrt_mclmc_warmup_launch": (_LANES_WARM + [_P] * 22, _I)},
    "nuts_fused_ld_posterior": {
        "nrt_ld_posterior_launch": (_NUTS_POST + [_P] * 17, _I),
        "nrt_ld_smem_bytes": ([_I, _I, _I], _LL),
        "nrt_ld_posterior_occupancy": ([_I, _I, _I, _P], _I)},
    "nuts_fused_ld_warmup": {
        "nrt_ld_warmup_launch": (_NUTS_WARM + [_P] * 18, _I),
        "nrt_ld_warmup_occupancy": ([_I, _I, _I, _P], _I)},
    "nuts_fused_ld_args_posterior": {
        "nrt_ld_args_posterior_launch": (_NUTS_POST + [_P] * 19, _I),
        "nrt_ld_args_smem_bytes": ([_I, _I, _I, _I, _P], _LL),
        "nrt_ld_args_posterior_blocks_per_sm": ([_I, _P, _LL], _I)},
    "nuts_fused_ld_args_warmup": {
        "nrt_ld_args_warmup_launch": (_NUTS_WARM + [_P] * 20, _I),
        "nrt_ld_args_warmup_blocks_per_sm": ([_I, _P, _LL], _I)},
    "nuts_fused_mid_posterior": {
        "nrt_mid_posterior_launch": (
            _NUTS_POST[:4] + [_I] + _NUTS_POST[4:] + [_P] * 19, _I),
        "nrt_mid_group_bytes": ([_I, _I, _I, _I, _P, _I], _LL),
        "nrt_mid_group": ([_I, _I, _I, _I, _P], _I),
        "nrt_mid_posterior_blocks_per_sm": ([_I, _P, _LL], _I)},
    "nuts_fused_mid_warmup": {
        "nrt_mid_warmup_launch": (
            _NUTS_WARM[:4] + [_I] + _NUTS_WARM[4:] + [_P] * 20, _I),
        "nrt_mid_warmup_blocks_per_sm": ([_I, _P, _LL], _I)},
    "mclmc_fused_mid_posterior": {
        "nrt_mclmc_mid_posterior_launch": (_MCLMC_POST + [_P] * 20, _I),
        "nrt_mclmc_block_form": ([_I, _I, _P, _I, _I, _P], None)},
    "mclmc_fused_mid_warmup": {
        "nrt_mclmc_mid_warmup_launch": (_MCLMC_WARM + [_P] * 24, _I)},
    "mclmc_fused_group_posterior": {
        "nrt_mclmc_group_posterior_launch": (
            [_I] * 6 + [_U] + [_F] * 4 + [_I, _F, _F] + [_P] * 19, _I),
        "nrt_mclmc_group_bytes": ([_I, _P, _I], _LL),
        "nrt_mclmc_group": ([_I, _P], _I),
        "nrt_mclmc_group_posterior_blocks_per_sm": ([_LL], _I)},
    "mclmc_fused_group_warmup": {
        "nrt_mclmc_group_warmup_launch": (
            [_I] * 6 + [_U] + [_F] * 5 + [_I, _F, _F, _I] + [_P] * 20, _I),
        "nrt_mclmc_group_warmup_blocks_per_sm": ([_LL], _I)},
    "nuts_fused_stream_posterior": {
        "nrt_stream_posterior_launch": (_NUTS_POST + [_P] * 21, _I),
        "nrt_stream_smem_bytes": ([_I, _I, _I, _P], _LL),
        "nrt_stream_resident_blocks": ([_LL], _I)},
}
# K1-flow: one library for each form of its flow (flow_form), the same C
# interface in both, so that the two build in parallel
_FLOW_API = {
    "nrt_flow_posterior_launch": (
        _NUTS_POST + [_I, _I, _F, _F, _I, _I] + [_P] * 20, _I),
    "nrt_flow_smem_bytes": ([_I, _I, _I, _P, _I, _I, _I, _I], _LL),
    "nrt_flow_form": ([_I, _I, _I, _P, _I, _I], _I),
    "nrt_flow_blocks_per_sm": ([_I, _I, _P, _LL], _I)}
FLOW_LIBRARIES = {"today": "nuts_fused_flow_posterior",
                  "warp": "nuts_fused_flow_warp_posterior"}
SOURCES.update((stem, _FLOW_API) for stem in FLOW_LIBRARIES.values())


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the fused CUDA kernels are built "
                           "from csrc/ with the CUDA toolkit")
    return path


def _sizes_header() -> str:
    cases = " ".join(f"X({d}, {D})" for d, D in SIZES)
    dims = " ".join(f"X({d})" for d in DIMS)
    return ("// Generated by nuts_rs_tpu_torch/kernels/_build.py\n"
            f"#define NRT_FOR_EACH_SIZE(X) {cases}\n"
            f"#define NRT_FOR_EACH_DIM(X) {dims}\n")


def _flags():
    return NVCC_FLAGS + [f"-D{m}" for m in NVCC_DEFINES]


def build_log(stem: str) -> Path:
    """Where nvcc's output for ``csrc/<stem>.cu`` under today's
    NVCC_DEFINES goes (``-Xptxas -v``: registers, stack, spills)."""
    tag = "".join("_" + re.sub(r"[^A-Za-z0-9]+", "_", d)
                  for d in NVCC_DEFINES)
    return BUILD_DIR / f"build_{stem}{tag}.log"


def _library_path(stem: str) -> Path:
    """Where the library of ``csrc/<stem>.cu`` lies: named by a hash of that
    source, every header, the flags and the instantiated sizes."""
    h = hashlib.sha256()
    for p in [CSRC / f"{stem}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(_flags()).encode())
    h.update(_sizes_header().encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def start_build(stems=None, nice=0, jobs=None):
    """Queue one ``nvcc`` per source of ``stems`` (default: every source)
    whose library is neither built nor building, in the order given, and
    return at once; at most ``jobs`` of them run at a time (default: all).
    ``library`` and ``build`` wait for a source's own ``nvcc`` alone.
    ``nice`` lowers the ``nvcc``s' priority (``nice -n``), so that a
    build in the background leaves the host's cores to the caller.  Each
    ``nvcc``'s own seconds go to ``BUILD_INFO["nvcc_seconds"]``."""
    stems = list(SOURCES) if stems is None else list(dict.fromkeys(stems))
    with _BUILD_LOCK:
        queue = [(stem, so) for stem in stems if stem not in _BUILDING
                 and not (so := _library_path(stem)).exists()]
        if not queue:
            return
        # the generated header is in place, whole, before any nvcc starts
        BUILD_DIR.mkdir(exist_ok=True)
        header = BUILD_DIR / "nrt_sizes.h"
        text = _sizes_header()
        if not header.exists() or header.read_text() != text:
            new = header.with_suffix(f".{os.getpid()}.tmp")
            new.write_text(text)
            new.replace(header)
        for stem, _ in queue:
            _BUILDING[stem] = threading.Event()
    threading.Thread(target=_run_queue, args=(queue, nice, jobs or len(queue)),
                     daemon=True).start()


def _run_queue(queue, nice, jobs):
    """Run the ``nvcc``s of ``start_build``, ``jobs`` at a time in the
    queue's order: put each library in place or keep its output, then mark
    the source done."""
    running = []
    while queue or running:
        while queue and len(running) < jobs:
            stem, so = queue.pop(0)
            log = build_log(stem)
            cmd = [_nvcc(), *_flags(), "-shared", "-I", str(BUILD_DIR), "-o",
                   str(so.with_suffix(".tmp")), str(CSRC / f"{stem}.cu")]
            if nice:
                cmd = ["nice", "-n", str(nice), *cmd]
            with open(log, "w") as out:
                running.append((stem, so, log, time.monotonic(),
                                subprocess.Popen(cmd, stdout=out,
                                                 stderr=subprocess.STDOUT)))
        for entry in [e for e in running if e[-1].poll() is not None]:
            running.remove(entry)
            stem, so, log, start, p = entry
            BUILD_INFO["nvcc_seconds"][stem] = time.monotonic() - start
            if p.returncode != 0:
                _BUILD_FAILED[stem] = (f"nvcc failed on {stem}.cu:\n"
                                       f"{log.read_text()}")
            else:
                so.with_suffix(".tmp").replace(so)
            _BUILDING[stem].set()
        time.sleep(0.02)


def build(stems=None):
    """Build the libraries of ``stems`` (default: every source) that are not
    built yet, one ``nvcc`` per source, all started together, and wait for
    them; raises if one failed."""
    stems = list(SOURCES) if stems is None else list(dict.fromkeys(stems))
    t0 = time.monotonic()
    start_build(stems)
    for stem in stems:
        if stem in _BUILDING:
            _BUILDING[stem].wait()
    failed = [_BUILD_FAILED[stem] for stem in stems if stem in _BUILD_FAILED]
    if failed:
        raise RuntimeError(failed[0])
    BUILD_INFO["seconds"] += time.monotonic() - t0


def library(stem: str):
    """The loaded library of ``csrc/<stem>.cu``, built on first use (or
    waited for, where ``start_build`` started it)."""
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    build([stem])
    so = _library_path(stem)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in SOURCES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    lib.nrt_error_string.argtypes = [_I]
    lib.nrt_error_string.restype = ctypes.c_char_p
    BUILD_INFO["libraries"][stem] = str(so)
    _LIBS[stem] = lib
    return lib


def check_tensor(name, x, shape, device, dtype=torch.float32):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} must lie on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar,
                         K):
    C, d = q.shape
    for name, x, shape in (("q", q, (C, d)), ("g", g, (C, d)),
                           ("stds", stds, (C, d)), ("mean", mean, (C, d)),
                           ("logp", logp, (C,)), ("logdet", logdet, (C,)),
                           ("step0", step0, (C,)),
                           ("step_bar", step_bar, (C,))):
        check_tensor(name, x, shape, q.device)
    if K < 1:
        raise ValueError("num_draws must be >= 1")


def check_warmup_args(flags, q, g, logp, stds, mean, est, sca, nsca=10):
    C, d = q.shape
    check_tensor("flags", flags, (flags.shape[0], 8), q.device, torch.int32)
    for name, x, shape in (("q", q, (C, d)), ("g", g, (C, d)),
                           ("stds", stds, (C, d)), ("mean", mean, (C, d)),
                           ("logp", logp, (C,)), ("est", est, (C, 8, d)),
                           ("sca", sca, (C, nsca))):
        check_tensor(name, x, shape, q.device)
    if flags.shape[0] < 1:
        raise ValueError("flags must hold at least one draw")


def check_mclmc_posterior_args(q, g, logp, v, stds, mean, logdet, step0,
                               step_bar, K, mopts):
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    check_tensor("v", v, q.shape, q.device)
    _check_esh_dim(q.shape[1], mopts)


def check_mclmc_warmup_args(flags, q, g, logp, v, stds, mean, est, sca,
                            mopts):
    check_warmup_args(flags, q, g, logp, stds, mean, est, sca, nsca=4)
    check_tensor("v", v, q.shape, q.device)
    _check_esh_dim(q.shape[1], mopts)


def _check_esh_dim(d, mopts):
    # the ESH step divides by d - 1 (undefined at d = 1 in the JAX package)
    if d < 2 and mopts.kind is KineticKind.MICROCANONICAL:
        raise ValueError("the microcanonical dynamics need dim >= 2")


def _common(q, model, opts, B, stem):
    """(C, d, maxdepth, model id, params, lanes) of a K1 / K2 launch, after
    the device, block and size checks and the lane rule's check against
    ``stem``'s library."""
    model_id, params = _model_and_block(q, model, B, coord=True)
    C, d = q.shape
    D = opts.maxdepth
    if (d, D) not in SIZES:
        raise ValueError(
            f"the chains-on-lanes kernels K1 / K2 are instantiated for (d, "
            f"maxdepth) in {SIZES}, not ({d}, {D}): the mid-d kernels serve "
            "every other size (nuts_fused.cl_kernel)")
    T = nuts_lanes(d, B)
    built = library(stem).nrt_nuts_lanes(d, B)
    if built != T:
        raise RuntimeError(f"csrc/nuts_tree.cuh gives {built} lanes a chain "
                           f"at d = {d}, B = {B}; _build.nuts_lanes {T}")
    return C, d, D, model_id, params, T


def _model_and_block(q, model, B, max_block=MAX_BLOCK, coord=False):
    """(model id, params) of the kernel hook, after the device and block
    checks.  ``coord``: the kernel takes the one-coordinate form
    (``COORD_FUNCTORS``; it reads no data), not the eval_block form, which
    every functor has."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {q.device}")
    C = q.shape[0]
    if model.kernel_hook is None or model.hook_parts()[0] not in MODEL_IDS:
        raise NotImplementedError(
            f"model {model.name!r} has no kernel hook the CUDA kernels "
            "compile in: the sampler plans such a model onto the sync "
            "engine (build_phases)")
    name, floats, tensors = model.hook_parts()
    if coord and name not in COORD_FUNCTORS:
        raise ValueError(
            f"the {name} functor has no form this kernel evaluates: the "
            "mid-d and ld_args kernels take it (nuts_fused.cl_kernel, "
            "nuts_fused._kernel_kind)")
    if not 1 <= B <= max_block or C % B:
        raise ValueError(f"chain block {B} must divide num_chains ({C}) and "
                         f"be at most {max_block}")
    params = (ctypes.c_float * max(1, len(floats)))(*floats)
    return MODEL_IDS[name], params


def _logistic_regression_data(tensors, d, device):
    """Checks ``(xt [d, N], y [N])``; returns the functor's sizes (N, d)."""
    if len(tensors) != 2:
        raise ValueError("logistic_regression carries (xt [d, N], y [N])")
    xt, y = tensors
    N = y.shape[0] if isinstance(y, torch.Tensor) and y.dim() == 1 else -1
    check_tensor("xt", xt, (d, N), device)
    check_tensor("y", y, (N,), device)
    if N < 1:
        raise ValueError("logistic_regression needs at least one row")
    return (N, d)


def _no_data(tensors, d, device):
    if tensors:
        raise ValueError("this functor carries no data")
    return ()


def _rank1_data(tensors, d, device):
    """Checks ``(u [d], s [d])``."""
    if len(tensors) != 2:
        raise ValueError("correlated_normal_rank1 carries (u [d], s [d])")
    for name, t in zip(("u", "s"), tensors):
        check_tensor(name, t, (d,), device)
    return ()


def _radon_data(tensors, d, device):
    """Checks ``(x [N], y [N], offsets [J + 1])`` with ``d = J + 4``, the
    rows sorted by group; returns (N, J)."""
    if len(tensors) != 3:
        raise ValueError("radon carries (x [N], y [N], offsets [J + 1])")
    x, y, off = tensors
    N = x.shape[0] if isinstance(x, torch.Tensor) and x.dim() == 1 else -1
    J = d - 4
    check_tensor("x", x, (N,), device)
    check_tensor("y", y, (N,), device)
    check_tensor("offsets", off, (J + 1,), device, torch.int32)
    if J < 1 or N < 1:
        raise ValueError("radon needs a group and a row")
    return (N, J)


def _sv_data(tensors, d, device):
    """Checks ``(r [T],)`` with ``d = T + 2``; returns (T,)."""
    if len(tensors) != 1:
        raise ValueError("stochastic_volatility carries (r [T],)")
    check_tensor("r", tensors[0], (d - 2,), device)
    if d < 3:
        raise ValueError("stochastic_volatility needs a return")
    return (d - 2,)


def _sv_scratch(ints):
    """StochasticVolatility::scratch_floats: a run of R = ceil(T / 256)
    floats a thread, two scans' warp totals."""
    runs = max(1, -(-ints[0] // (32 * LD_WARPS)))
    return 32 * LD_WARPS * runs + 2 * LD_WARPS


# per kernel hook name: (the check of its tensors, which returns the ints
# the functor takes; the functor's shared-memory scratch in floats from
# those ints), as csrc/models.cuh::with_block_model and scratch_floats
_MODEL_DATA = {
    "iid_normal": (_no_data, lambda ints: 0),
    "logistic_regression": (_logistic_regression_data,
                            lambda ints: ints[0] + LD_WARPS * ints[1]),
    "correlated_normal_rank1": (_rank1_data, lambda ints: 0),
    "radon": (_radon_data, lambda ints: 0),
    "stochastic_volatility": (_sv_data, _sv_scratch),
    "funnel": (_no_data, lambda ints: 0),
    "correlated_normal": (_no_data, lambda ints: 0),
}


# the group form's scratch in floats from the functor's ints and G, for the
# functors that have one (csrc/models.cuh: LogisticRegression::group_floats:
# qg [d][8], part [G][d][8], llp [G][8], a warp's [32][36] for the second
# product's butterflies, rs [G][N] past the registers)
_GROUP_FLOATS = {
    "logistic_regression": lambda ints, G: (
        GROUP_MAX * ints[1] + G * LD_WARPS * (ints[1] + 1)
        + LD_WARPS * 32 * 36
        + (0 if ints[0] <= GROUP_ROWS_IN_REGISTERS else G * ints[0])),
}


def model_data_args(model, d, device):
    """(ints, ptrs) of a model's hook tensors for a mid-d launch, after the
    functor's own check of them on ``device``."""
    name, _, tensors = model.hook_parts()
    ints = _MODEL_DATA[name][0](tensors, d, torch.device(device))
    return ints, [t.data_ptr() for t in tensors]


def mid_smem_bytes(kind, d, maxdepth, model):
    """Dynamic shared memory of one chain's CUDA block of 256 threads that
    evaluates the model in its eval_block form: the ld_args kernel ``kind``
    ("posterior" / "warmup") and, for the posterior, K1-flow
    (``flow_smem_bytes``): the dim-on-lanes layout of ``ld_smem_bytes``
    with ``MID_NVEC`` vectors, then the model functor's scratch, whose size
    comes from the functor's check of the model's data where they lie.  The
    mid-d kernels lay out G chains a block (``mid_group_bytes``)."""
    return 4 * (MID_NVEC[kind] * d + 2 * (maxdepth + 1) + LD_REDUCE_FLOATS
                + 2 * MAX_LD_BLOCK + _scratch_floats(model, d))


def _hook_ints(model, d):
    """(hook name, the ints its functor takes) from the functor's check of
    the model's data where they lie."""
    name, _, tensors = model.hook_parts()
    return name, _MODEL_DATA[name][0](tensors, d, tensors[0].device
                                      if tensors else None)


def _scratch_floats(model, d):
    """Shared-memory floats of a model functor's scratch."""
    name, ints = _hook_ints(model, d)
    return _MODEL_DATA[name][1](ints)


def _round4(n):
    return -(-n // 4) * 4


def mid_group_bytes(kind, d, maxdepth, model, G):
    """Dynamic shared memory of a CUDA block of ``G`` chains in the mid-d
    kernel ``kind`` (K1-args / K2-args), as csrc/nuts_tree_group.cuh lays it
    out: the group form's scratch (the regression's), the chain flags, the
    chains' scalars while the group form runs, then G chain parts of
    ``MID_NVEC`` vectors, the two cached-dot rows and,
    for a functor without the group form, its scratch, every part a
    multiple of 4 floats."""
    name, ints = _hook_ints(model, d)
    nvec, D1 = MID_NVEC[kind], maxdepth + 1
    if name in _GROUP_FLOATS:
        group = _GROUP_FLOATS[name](ints, G) + GROUP_SCALARS
        chain = nvec * d + 2 * D1
    else:
        group, chain = 0, nvec * d + 2 * D1 + _MODEL_DATA[name][1](ints)
    return 4 * (_round4(group) + GROUP_FLAGS + G * _round4(chain))


def mid_group(kind, d, maxdepth, model):
    """The chains a CUDA block of the mid-d kernel ``kind`` serves: the most,
    a power of two up to ``GROUP_MAX``, whose block fits a block's opt-in
    shared memory (``mid_group_bytes``); 0 where one chain does not fit.
    csrc/nuts_tree_group.cuh::gr_chains is the same rule, and a launch
    checks that the two agree.  A logical chain block B must divide it."""
    for G in (8, 4, 2, 1):
        if mid_group_bytes(kind, d, maxdepth, model, G) <= SMEM_OPT_IN_BYTES:
            return G
    return 0


def mclmc_mid_smem_bytes(d, model):
    """Dynamic shared memory of one chain's CUDA block in either mid-d MCLMC
    kernel, as csrc/mclmc_step_block.cuh lays it out: the live vectors, the
    reduction scratch and the cluster slots, then the model functor's
    scratch.  No checkpoint stacks, so nothing depends on a depth."""
    return 4 * (MCLMC_MID_NVEC * d + LD_REDUCE_FLOATS + 2 * MAX_LD_BLOCK
                + _scratch_floats(model, d))


def mclmc_pair_bytes(d, model):
    """Dynamic shared memory of each CUDA block of the pair form of the
    block-form mid-d MCLMC kernels (the regression, csrc/models.cuh::
    glm_pair_floats): the chain's part as ``mclmc_mid_smem_bytes`` lays it
    out without the functor's scratch, then the block's half of the data
    (128 rows a round of 256, x and y), its residuals, the column partials
    of its 4 warps, two exchange buffers, its own halves and 4 warp sums."""
    name, ints = _hook_ints(model, d)
    if name != "logistic_regression":
        raise ValueError(f"the {name} functor has no pair form")
    rows = 128 * -(-ints[0] // 256)
    return 4 * (MCLMC_MID_NVEC * d + LD_REDUCE_FLOATS + 2 * MAX_LD_BLOCK
                + d * rows + 2 * rows + 4 * d + 3 * (d + 1) + 4)


# Launches of the block-form mid-d MCLMC kernels (csrc/mclmc_fused_mid_
# posterior.cu, csrc/mclmc_fused_mid_warmup.cu) by kind and form
# ("posterior pair", "warmup T256", ...: block_form_name of
# mclmc_block_form), beside the kernels' own counts, which also count their
# group form.
MCLMC_BLOCK_FORM_LAUNCHES = {f"{kind} {form}": 0
                             for kind in ("posterior", "warmup")
                             for form in ("pair", "T256")}


def block_form_name(form):
    """"pair" for the pair form, "T<threads>" for one block a chain."""
    T, X = form
    return "pair" if X == 2 else f"T{T}"


def mclmc_block_form(d, model, B, mopts):
    """(T, X) of a block-form mid-d MCLMC launch: T threads a CUDA block, X
    blocks a chain (csrc/mclmc_step_block.cuh::mc_block_form, the same rule,
    checked at every launch).  The pair form (128, 2) for the regression
    under the Euclidean dynamics where its rows fit two blocks' shared
    memory (``mclmc_pair_bytes``) and the logical chain block is one chain:
    one chain's iteration reads x from shared memory instead of L2, and its
    exchange waits at the cluster's barrier, which the chains of a larger
    block would reach at different points.  Else (256, 1), the form every
    launch took before (128 and 64 threads a chain lost to it at d = 400).
    A form chosen by the shapes, never a fallback; measured in
    profile_main_path.py item 22 (PERF.md section 6)."""
    if (model.hook_parts()[0] == "logistic_regression"
            and mopts.kind is not KineticKind.MICROCANONICAL and B == 1
            and mclmc_pair_bytes(d, model) <= SMEM_OPT_IN_BYTES):
        return 128, 2
    return 256, 1


def mclmc_mid_group_bytes(d, model, G):
    """Dynamic shared memory of a CUDA block of ``G`` chains in the group
    form of either mid-d MCLMC kernel (K3-args / K4-args on the
    regression), as csrc/mclmc_step_group.cuh lays it out: the regression's
    group scratch, the chain flags, the chains' scalars while the group form
    runs, then G chain parts of ``MCLMC_MID_NVEC`` vectors, every part a
    multiple of 4 floats.  No checkpoint stacks, so nothing depends on a
    depth."""
    name, ints = _hook_ints(model, d)
    if name not in _GROUP_FLOATS:
        raise ValueError(f"the {name} functor has no group form")
    group = _GROUP_FLOATS[name](ints, G) + GROUP_SCALARS
    return 4 * (_round4(group) + GROUP_FLAGS + G * _round4(MCLMC_MID_NVEC * d))


def mclmc_mid_group(d, model):
    """The chains a CUDA block of the group-form MCLMC kernels serves: the
    most, a power of two up to ``GROUP_MAX``, whose block fits a block's
    opt-in shared memory (``mclmc_mid_group_bytes``); 0 where one chain does
    not fit.  csrc/mclmc_step_group.cuh::mg_chains is the same rule, and a
    launch checks that the two agree."""
    for G in (8, 4, 2, 1):
        if mclmc_mid_group_bytes(d, model, G) <= SMEM_OPT_IN_BYTES:
            return G
    return 0


def mclmc_mid_group_for(d, model, B):
    """``mclmc_mid_group``'s G for a launch in logical chain blocks of B;
    raises where one chain does not fit, or where B does not divide G (a
    chain block never spans CUDA blocks)."""
    G = mclmc_mid_group(d, model)
    if G < 1:
        raise NotImplementedError(
            f"model {model.name!r} at dim {d} needs "
            f"{mclmc_mid_group_bytes(d, model, 1)} bytes of shared memory "
            f"for one chain in the group-form MCLMC kernels; a block has "
            f"{SMEM_OPT_IN_BYTES}: data of that size must stream (ROADMAP.md "
            "queue 1 item 12)")
    if G % B:
        raise ValueError(
            f"the group-form MCLMC kernels serve {G} chains a CUDA block "
            f"(their shared memory), which must be a multiple of the chain "
            f"block {B}")
    return G


# The form of the mid-d MCLMC kernels K3-args and K4-args for each functor
# they take (every hook of MODEL_IDS but the streamed regression) and each
# kinetic energy, with the measurement that chose it: profile_main_path.py
# item 14, each launch on its own path's states against the
# 256-threads-a-chain form in the same chip call (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 6).  "group": G <= 8 chains a CUDA block of 256 threads, a warp a
# chain's trajectory, the regression evaluated by the whole block for its G
# chains (csrc/mclmc_fused_group_*.cu); "block": 256 threads a chain's
# trajectory, logical chain blocks as thread block clusters
# (csrc/mclmc_fused_mid_*.cu).  A chain on one warp takes about 10 us an
# iteration without the evaluation, 256 threads about 4: the group form
# wins only where one read of the data serves G chains and the chains of a
# block need about as many iterations.
_ONE_WARP = ("a chain's iteration on one warp (10 us) is longer than on 256 "
             "threads (4 us) and no data read is shared: ")
MCLMC_MID_FORMS = {
    ("logistic_regression", "microcanonical"): (
        "group", "one read of x serves 8 chains: K3-args 97.20 -> 53.87 ms, "
                 "K4-args' first microcanonical chunk 105.69 -> 52.85 ms "
                 "(N = 1000, d = 100, 1024 chains)"),
    ("logistic_regression", "euclidean"): (
        "block", "the warmup's Euclidean draws 0-90 from the initial state "
                 "differ 10x between chains (653 iterations on average, 6263 "
                 "the most) and a block of 8 runs to its slowest chain: "
                 "344.86 ms against 173.82"),
    ("iid_normal", "microcanonical"): (
        "block", _ONE_WARP + "d = 100, 256 chains 3.21 -> 7.85 ms (1024 "
                 "chains 8.65 -> 8.12)"),
    ("correlated_normal_rank1", "microcanonical"): (
        "block", _ONE_WARP + "d = 100, 256 chains 3.52 -> 9.11 ms"),
    ("radon", "microcanonical"): (
        "block", _ONE_WARP + "1024 chains 21.77 -> 27.05 ms"),
    ("stochastic_volatility", "microcanonical"): (
        "block", _ONE_WARP + "T = 300, 256 chains 13.12 -> 40.13 ms"),
    ("funnel", "microcanonical"): (
        "block", _ONE_WARP + "d = 10, 256 chains 3.45 -> 5.44 ms"),
    ("correlated_normal", "microcanonical"): (
        "block", _ONE_WARP + "d = 100, 256 chains 3.50 -> 8.16 ms"),
    **{(name, "euclidean"): (
        "block", "as under the microcanonical dynamics (not measured apart): "
                 "no data read to share")
       for name in ("iid_normal", "correlated_normal_rank1", "radon",
                    "stochastic_volatility", "funnel", "correlated_normal")},
}


def mclmc_mid_form(model, mopts):
    """The form, "group" or "block", that the mid-d MCLMC kernels take for
    ``model``'s functor under ``mopts``' kinetic energy
    (``MCLMC_MID_FORMS``)."""
    kind = mopts.kind.name.lower()
    return MCLMC_MID_FORMS[(model.hook_parts()[0], kind)][0]


def mclmc_mid_blocks_per_sm(kind, model, G):
    """CUDA blocks of G chains one SM holds of the group-form MCLMC kernel
    ``kind`` for ``model`` at its own d
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at
    ``mclmc_mid_group_bytes``); raises where it is none."""
    smem = mclmc_mid_group_bytes(model.dim, model, G)
    key = ("mclmc_group", kind, smem)
    n = _BLOCKS_PER_SM.get(key)
    if n is None:
        lib = library(f"mclmc_fused_group_{kind}")
        n = getattr(lib, f"nrt_mclmc_group_{kind}_blocks_per_sm")(smem)
        if n < 0:
            _raise_on(-n, lib, f"mclmc_fused_group_{kind} occupancy")
        _BLOCKS_PER_SM[key] = n
    if n < 1:
        raise RuntimeError(f"an SM holds no block of {G} chains of the "
                           f"group-form MCLMC {kind} kernel ({smem} bytes "
                           "of shared memory)")
    return n


def _mclmc_consts(d, mopts):
    """The dynamics' template flags (microcanonical, dynamic step size) and
    f32 constants (max_energy_error, L, F L, sqrt(d)) of an MCLMC launch."""
    L = float(mopts.momentum_decoherence_length)
    consts = (int(mopts.kind is KineticKind.MICROCANONICAL),
              int(mopts.dynamic_step_size))
    fconsts = (float(mopts.max_energy_error), L,
               float(mopts.subsample_frequency) * L, math.sqrt(d))
    return consts, fconsts


MAX_THREADS = 1024  # of a CUDA block


def _lanes_define(name):
    """n of the ablation macro ``name=n`` in NVCC_DEFINES, or None."""
    for define in NVCC_DEFINES:
        if define.startswith(name + "="):
            return int(define.split("=", 1)[1])
    return None


def nuts_lanes(d, B):
    """Lanes of a chain in K1 / K2 at d coordinates in logical chain blocks
    of B (csrc/nuts_tree.cuh::nuts_lanes, the same rule, checked at every
    launch): 4 at every instantiated d and block (at most 512 threads a
    block).  At d = 10 and B = 32, 4 lanes beat 8 and 16 on the path's own
    states (profile_main_path.py item 18): a chain's scalar work runs on
    every lane of its group, so more lanes issue it more often on the
    block's one SM.  A form chosen by the shapes, not a fallback.  Under
    the ablation macro NRT_NUTS_LANES=n every shape takes n lanes."""
    fixed = _lanes_define("NRT_NUTS_LANES")
    return 4 if fixed is None else fixed


def mclmc_lanes(d, B):
    """Lanes of a chain in K3 / K4 at d coordinates in logical chain blocks
    of B (csrc/mclmc_step.cuh::mclmc_lanes, the same rule, checked at every
    launch): one coordinate a lane, 4 lanes at d <= 4, 8 at d <= 8, 16
    above, halved while the block's B * T threads exceed 1024: at d = 10, 16
    lanes for B <= 64 and 8 for B = 65..128.  A form chosen by the shapes,
    not a fallback.  Under the ablation macro NRT_MCLMC_LANES=n every shape
    takes n lanes."""
    fixed = _lanes_define("NRT_MCLMC_LANES")
    if fixed is not None:
        return fixed
    T = 4 if d <= 4 else (8 if d <= 8 else 16)
    while T > 4 and B * T > MAX_THREADS:
        T //= 2
    return T


def _mclmc_common(q, model, mopts, B):
    model_id, params = _model_and_block(q, model, B, coord=True)
    C, d = q.shape
    if d not in DIMS:
        raise ValueError(
            f"the chains-on-lanes MCLMC kernels K3 / K4 are instantiated "
            f"for d in {DIMS}, not {d}: the mid-d kernels serve every other "
            "size "
            "(nuts_fused.cl_kernel)")
    consts, fconsts = _mclmc_consts(d, mopts)
    T = mclmc_lanes(d, B)
    built = library("mclmc_fused_posterior").nrt_mclmc_lanes(d, B)
    if built != T:
        raise RuntimeError(f"csrc/mclmc_step.cuh gives {built} lanes a chain "
                           f"at d = {d}, B = {B}; _build.mclmc_lanes {T}")
    return C, d, model_id, params, (*consts, T), fconsts


def _mclmc_mid_common(kind, q, model, mopts, B):
    """(C, d, model id, params, ptrs, ints, consts, fconsts, lib, form) of a
    block-form mid-d MCLMC launch, after the device, block, size and data
    checks; ``form`` is ``mclmc_block_form``'s (T, X), checked against
    csrc/mclmc_step_block.cuh::mc_block_form with its bytes."""
    model_id, params = _model_and_block(q, model, B, MAX_LD_BLOCK)
    C, d = q.shape
    ints, ptrs = model_data_args(model, d, q.device)
    need = mclmc_mid_smem_bytes(d, model)
    if need > SMEM_OPT_IN_BYTES:
        raise NotImplementedError(
            f"model {model.name!r} at dim {d} needs {need} bytes of shared "
            f"memory per chain in the mid-d MCLMC kernels; a block has "
            f"{SMEM_OPT_IN_BYTES}: data of that size must stream (ROADMAP.md "
            "queue 1 item 12)")
    form = mclmc_block_form(d, model, B, mopts)
    if form[1] == 2:
        need = mclmc_pair_bytes(d, model)
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    c_ptrs = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    built = (ctypes.c_longlong * 3)()
    library("mclmc_fused_mid_posterior").nrt_mclmc_block_form(
        d, model_id, ctypes.cast(c_ints, ctypes.c_void_p), B,
        int(mopts.kind is KineticKind.MICROCANONICAL),
        ctypes.cast(built, ctypes.c_void_p))
    if tuple(built) != (*form, need):
        raise RuntimeError(
            f"csrc/mclmc_step_block.cuh gives the block form (T, X, bytes) "
            f"{tuple(built)} at d = {d}, B = {B}; _build.mclmc_block_form "
            f"{(*form, need)}")
    consts, fconsts = _mclmc_consts(d, mopts)
    lib = library(f"mclmc_fused_mid_{kind}")
    return C, d, model_id, params, c_ptrs, c_ints, consts, fconsts, lib, form


def _mclmc_group_common(kind, q, model, mopts, B):
    """(C, d, G, ptrs, ints, dynamic, fconsts, lib) of a group-form MCLMC
    launch, after the device, block, size and data checks: the launch
    serves ``mclmc_mid_group_for``'s G chains a CUDA block, and the block
    must fit an SM (``mclmc_mid_blocks_per_sm``), or this raises."""
    _model_and_block(q, model, B, MAX_LD_BLOCK)
    C, d = q.shape
    ints, ptrs = model_data_args(model, d, q.device)
    G = mclmc_mid_group_for(d, model, B)
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    c_ptrs = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    p_ints = ctypes.cast(c_ints, ctypes.c_void_p)
    probe = library("mclmc_fused_group_posterior")
    built = probe.nrt_mclmc_group(d, p_ints)
    need = mclmc_mid_group_bytes(d, model, G)
    got = probe.nrt_mclmc_group_bytes(d, p_ints, G)
    if built != G or got != need:
        raise RuntimeError(
            f"csrc/mclmc_step_group.cuh gives G = {built} and {got} bytes "
            f"for the group-form MCLMC kernels, _build.mclmc_mid_group {G} "
            f"and mclmc_mid_group_bytes {need}")
    mclmc_mid_blocks_per_sm(kind, model, G)
    consts, fconsts = _mclmc_consts(d, mopts)
    return (C, d, G, c_ptrs, c_ints, consts[1], fconsts,
            library(f"mclmc_fused_group_{kind}"))


# K1-stream's tiling of a data phase (csrc/models.cuh::
# LogisticRegressionStream): sub-tiles of at most 128 rows staged in shared
# memory, groups of at most 64 chains; neither changes a bit of the result.
STREAM_MAX_SUBTILE = 128
STREAM_MAX_GROUP = 64


def stream_block_smem_limit(B):
    """Shared memory each of K1-stream's CUDA blocks may use: its logical
    block of B chains is one cooperative grid, resident at once, so above
    ``H100_SMS`` chains two blocks share an SM (115,712 bytes each; up to
    ``H100_SMS`` chains a block's opt-in)."""
    return SM_SMEM_BYTES // -(-B // H100_SMS) - SMEM_BLOCK_RESERVED


def stream_tiling(d, B, maxdepth):
    """``(S, CG)`` of a K1-stream launch: the chain group CG, the largest of
    64, 32, 16, 8 whose gradient tiles (8 chains x 4 columns) the block's
    256 threads hold at once, ``CG / 8 * ceil(d / 4) <= 256``, and no larger
    than the block needs; the sub-tile S, the largest of 128, 64, ..., 4
    rows with which a chain's shared memory fits a block at the blocks an
    SM that B chains need (:func:`stream_block_smem_limit`)."""
    CG = STREAM_MAX_GROUP
    while CG > 8 and (CG // 8 * -(-d // 4) > 32 * LD_WARPS or CG // 2 >= B):
        CG //= 2
    if CG // 8 * -(-d // 4) > 32 * LD_WARPS:
        raise NotImplementedError(
            f"the streamed kernel takes d up to {4 * 32 * LD_WARPS}, got {d}")
    limit = stream_block_smem_limit(B)
    S = STREAM_MAX_SUBTILE
    while S > 4 and stream_smem_bytes(d, maxdepth, S, CG) > limit:
        S //= 2
    if stream_smem_bytes(d, maxdepth, S, CG) > limit:
        raise NotImplementedError(
            f"dim {d} needs {stream_smem_bytes(d, maxdepth, S, CG)} bytes of "
            f"shared memory per chain in the streamed kernel; each of its "
            f"blocks has {limit} at a logical block of {B} chains")
    return S, CG


def stream_resident_blocks(d, B, maxdepth):
    """How many of K1-stream's CUDA blocks the card holds at once at the
    shared memory of a logical block of B chains
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times the SMs, from
    the kernel's library)."""
    S, CG = stream_tiling(d, B, maxdepth)
    lib = library("nuts_fused_stream_posterior")
    n = lib.nrt_stream_resident_blocks(stream_smem_bytes(d, maxdepth, S, CG))
    if n < 0:
        _raise_on(-n, lib, "nuts_fused_stream_posterior occupancy")
    return n


def check_stream_resident(d, B, maxdepth):
    """Raise unless K1-stream's logical block of B chains can be resident at
    once on this card: checked before a sampler's warmup, so that a block
    the card cannot hold fails before the first posterior launch."""
    n = stream_resident_blocks(d, B, maxdepth)
    if n < B:
        S, CG = stream_tiling(d, B, maxdepth)
        raise RuntimeError(
            f"the streamed kernel's logical block of {B} chains cannot be "
            f"resident at once: the card holds {n} of its blocks at "
            f"{stream_smem_bytes(d, maxdepth, S, CG)} bytes of shared memory "
            f"each (d = {d}, maxdepth {maxdepth}, sub-tile {S})")


def stream_smem_bytes(d, maxdepth, S, CG):
    """Dynamic shared memory of one chain's CUDA block in the streamed
    posterior kernel: the mid-d posterior layout, then the streamed
    functor's scratch (csrc/models.cuh): 4 floats of slack for alignment,
    S staged rows of x at an odd stride of at least d + 1, the group's
    positions or residuals, and the quad sums of the log-likelihood; whatever
    the rows of data, of a tile or the ranges."""
    scratch = 4 + S * ((d + 1) | 1) + max(d, S) * CG + S // 4 * CG
    return 4 * (MID_NVEC["posterior"] * d + 2 * (maxdepth + 1)
                + LD_REDUCE_FLOATS + 2 * MAX_LD_BLOCK + scratch)


def stream_workspace_floats(R, B, d):
    """Floats of K1-stream's global workspace besides the checkpoint
    stacks: the block's positions [d, B] and the ranges' partial sums
    [R, B, d + 1]."""
    return d * B + R * B * (d + 1)


def _ld_layout_bytes(kind, d, maxdepth, merged):
    """Dynamic shared memory of one chain's CUDA block in the ld kernel
    ``kind`` ("posterior" / "warmup"), as csrc/nuts_tree_ld.cuh lays it out:
    the live vectors, the two cached-dot rows, the reduction scratch and
    the cluster slots, and with ``merged`` the wide reduction's scratch."""
    return 4 * (LD_NVEC[kind] * d + 2 * (maxdepth + 1) + LD_REDUCE_FLOATS
                + 2 * MAX_LD_BLOCK + (LD_WIDE_FLOATS if merged else 0))


def ld_form(kind, d, maxdepth):
    """The form of K1-ld / K2-ld (``kind`` "posterior" / "warmup") at
    (d, maxdepth): "merged" (csrc/nuts_tree_ld.cuh::ld_leap_merged, one
    reduction a leapfrog and its checks, with 2 KB more of reduction
    scratch) where its layout fits a block's shared memory, else "today"
    (one reduction a U-turn level), which serves d up to ``ld_max_dim``
    (the posterior's 2733..2757 at maxdepth 10).  The kernels pick theirs
    by the same rule (nuts_tree_ld.cuh::ld_kernel_form); under the
    ablation macro NRT_LD_TODAY the merged form's kernel runs today's
    leapfrog and lays out today's bytes."""
    merged = "NRT_LD_TODAY" not in NVCC_DEFINES
    fits = _ld_layout_bytes(kind, d, maxdepth, merged) <= SMEM_OPT_IN_BYTES
    return "merged" if fits else "today"


def ld_smem_bytes(kind, d, maxdepth):
    """Dynamic shared memory of one chain's CUDA block in the ld kernel
    ``kind`` ("posterior" / "warmup") in the form ``ld_form`` picks."""
    merged = (ld_form(kind, d, maxdepth) == "merged"
              and "NRT_LD_TODAY" not in NVCC_DEFINES)
    return _ld_layout_bytes(kind, d, maxdepth, merged)


def ld_max_dim(maxdepth, scratch_floats=0):
    """Largest d whose chain state fits a block's shared memory in both ld
    kernels (today's form serves the d where the merged one does not fit);
    with a functor's ``scratch_floats`` (the ld_args kernels, whose warmup
    keeps 19 vectors and posterior 21), in both ld_args kernels."""
    nvec = max(LD_NVEC.values())
    return (SMEM_OPT_IN_BYTES - _ld_layout_bytes("posterior", 0, maxdepth,
                                                 False)
            - 4 * scratch_floats) // (4 * nvec)


def ld_occupancy(kind, d, maxdepth, B=MAX_LD_BLOCK):
    """(chain blocks one SM holds, clusters of B chains the card holds at
    once) of K1-ld / K2-ld (``kind``) at (d, maxdepth), in the form
    ``ld_form`` picks (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
    ``cudaOccupancyMaxActiveClusters``)."""
    lib = library(f"nuts_fused_ld_{kind}")
    out = (ctypes.c_int * 2)()
    rc = getattr(lib, f"nrt_ld_{kind}_occupancy")(
        d, maxdepth, B, ctypes.cast(out, ctypes.c_void_p))
    _raise_on(rc, lib, f"nuts_fused_ld_{kind} occupancy")
    return out[0], out[1]


def ld_fits(model, maxdepth):
    """Whether ``model`` at its own d fits a block's shared memory in both
    dim-on-lanes kernels that would take it (K1-ld / K2-ld for a functor of
    the term / finish form, else K1-ld-args / K2-ld-args with the functor's
    scratch at the model's data)."""
    if model.kernel_hook is None or model.hook_parts()[0] in COORD_FUNCTORS:
        return model.dim <= ld_max_dim(maxdepth)
    return model.dim <= ld_max_dim(maxdepth,
                                   _scratch_floats(model, model.dim))


def _ld_common(kind, q, model, opts, B):
    """(C, d, D, model id, params, workspace) of an ld launch, after the
    device, block and size checks.  The workspace holds the four checkpoint
    stacks of every chain, [C, 4, D + 1, d]; the kernels write a row before
    they read it, so it is not cleared."""
    model_id, params = _model_and_block(q, model, B, MAX_LD_BLOCK,
                                        coord=True)
    C, d = q.shape
    D = opts.maxdepth
    if not 1 <= D <= LD_MAX_MAXDEPTH:
        raise NotImplementedError(
            f"the dim-on-lanes CUDA kernels take maxdepth 1..{LD_MAX_MAXDEPTH}"
            f", got {D}")
    need = ld_smem_bytes(kind, d, D)
    if need > SMEM_OPT_IN_BYTES:
        raise NotImplementedError(
            f"dim {d} needs {need} bytes of shared memory per chain in the "
            f"dim-on-lanes {kind} kernel; a block has {SMEM_OPT_IN_BYTES} "
            f"(d <= {ld_max_dim(D)} at maxdepth {D})")
    built = library("nuts_fused_ld_posterior").nrt_ld_smem_bytes(
        int(kind == "warmup"), d, D)
    if built != need:
        raise RuntimeError(f"csrc/nuts_tree_ld.cuh lays out {built} bytes of "
                           f"shared memory, _build.ld_smem_bytes {need}")
    work = torch.empty(C, 4, D + 1, d, dtype=torch.float32, device=q.device)
    return C, d, D, model_id, params, work, library(f"nuts_fused_ld_{kind}")


def _mid_common(kind, q, model, opts, B, family="mid"):
    """(C, d, D, model id, params, ptrs, ints, workspace, lib, G) of a
    launch of the mid-d kernel (``family`` "mid") or of the dim-on-lanes
    kernel with data ("ld_args"; G None), after the device, block, size and
    data checks.  ``ptrs`` and ``ints`` are ctypes arrays of the hook
    tensors' device pointers and of the sizes their functor takes.  A
    mid-d launch serves ``mid_launch_group``'s G chains a CUDA block; B must
    divide the rule's G, and the block must fit an SM
    (``mid_blocks_per_sm``), or this raises."""
    model_id, params = _model_and_block(q, model, B, MAX_LD_BLOCK)
    C, d = q.shape
    D = opts.maxdepth
    what = {"mid": "mid-d", "ld_args": "dim-on-lanes"}[family]
    if not 1 <= D <= LD_MAX_MAXDEPTH:
        raise NotImplementedError(
            f"the {what} CUDA kernels take maxdepth 1..{LD_MAX_MAXDEPTH}, "
            f"got {D}")
    ints, ptrs = model_data_args(model, d, q.device)
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    c_ptrs = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    probe = library(f"nuts_fused_{family}_posterior")
    p_ints = ctypes.cast(c_ints, ctypes.c_void_p)
    G = None
    if family == "mid":
        rule = mid_group_for(kind, d, D, model, B)
        G = mid_launch_group(kind, d, D, model, C, B, sm_count(q.device))
        built = probe.nrt_mid_group(int(kind == "warmup"), d, D, model_id,
                                    p_ints)
        need = mid_group_bytes(kind, d, D, model, G)
        got = probe.nrt_mid_group_bytes(int(kind == "warmup"), d, D,
                                        model_id, p_ints, G)
        if built != rule or got != need:
            raise RuntimeError(
                f"csrc/nuts_tree_group.cuh gives G = {built} and {got} bytes "
                f"for the mid-d {kind} kernel, _build.mid_group {rule} and "
                f"mid_group_bytes {need}")
        mid_blocks_per_sm(kind, model, D, G)
    else:
        need = mid_smem_bytes(kind, d, D, model)
        if need > SMEM_OPT_IN_BYTES:
            raise NotImplementedError(
                f"model {model.name!r} at dim {d} needs {need} bytes of "
                f"shared memory per chain in the {what} {kind} kernel; a "
                f"block has {SMEM_OPT_IN_BYTES} (ROADMAP.md queue 1 item 12)")
        built = probe.nrt_ld_args_smem_bytes(int(kind == "warmup"), d, D,
                                             model_id, p_ints)
        if built != need:
            raise RuntimeError(f"csrc lays out {built} bytes of shared "
                               f"memory for the {what} {kind} kernel, "
                               f"_build.mid_smem_bytes {need}")
    work = torch.empty(C, 4, D + 1, d, dtype=torch.float32, device=q.device)
    return (C, d, D, model_id, params, c_ptrs, c_ints, work,
            library(f"nuts_fused_{family}_{kind}"), G)


def mid_group_for(kind, d, maxdepth, model, B):
    """The chains a CUDA block of a mid-d launch in logical chain blocks of
    B: ``mid_group``'s; raises where one chain does not fit, or where B does
    not divide G (a chain block never spans CUDA blocks)."""
    G = mid_group(kind, d, maxdepth, model)
    if G < 1:
        raise NotImplementedError(
            f"model {model.name!r} at dim {d} needs "
            f"{mid_group_bytes(kind, d, maxdepth, model, 1)} bytes of shared "
            f"memory for one chain in the mid-d {kind} kernel; a block has "
            f"{SMEM_OPT_IN_BYTES} (ROADMAP.md queue 1 item 12)")
    if G % B:
        raise ValueError(
            f"the mid-d {kind} kernel serves {G} chains a CUDA block (its "
            f"shared memory), which must be a multiple of the chain block "
            f"{B}")
    return G


def mid_launch_group(kind, d, maxdepth, model, C, B, sms):
    """The chains a CUDA block of a mid-d launch of C chains in logical
    blocks of B on a card of ``sms`` SMs.  The regression's group form
    takes ``mid_group_for``'s G: one read of its data serves them all.  A
    functor without it evaluates each chain on its own warp, so more chains
    a block only pack them onto fewer SMs: it takes the fewest, a power of
    two and a multiple of B, whose ceil(C / G) blocks (one an SM) fit the
    card in one wave, up to the rule's G."""
    G = mid_group_for(kind, d, maxdepth, model, B)
    if model.hook_parts()[0] in _GROUP_FLOATS:
        return G
    fewest = B
    while fewest < G and -(-C // fewest) > sms:
        fewest *= 2
    return fewest


_SMS = {}


def sm_count(device):
    """SMs of the card ``device`` (cached)."""
    device = torch.device(device)
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


_BLOCKS_PER_SM = {}


def mid_blocks_per_sm(kind, model, maxdepth, G):
    """CUDA blocks of G chains one SM holds of the mid-d kernel ``kind`` for
    ``model`` at its own d (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at ``mid_group_bytes``); raises where it is none."""
    d = model.dim
    name, ints = _hook_ints(model, d)
    smem = mid_group_bytes(kind, d, maxdepth, model, G)
    key = (kind, name, tuple(ints), smem)
    n = _BLOCKS_PER_SM.get(key)
    if n is None:
        c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
        lib = library(f"nuts_fused_mid_{kind}")
        n = getattr(lib, f"nrt_mid_{kind}_blocks_per_sm")(
            MODEL_IDS[name], ctypes.cast(c_ints, ctypes.c_void_p), smem)
        if n < 0:
            _raise_on(-n, lib, f"nuts_fused_mid_{kind} occupancy")
        _BLOCKS_PER_SM[key] = n
    if n < 1:
        raise RuntimeError(f"an SM holds no block of {G} chains of the mid-d "
                           f"{kind} kernel ({smem} bytes of shared memory)")
    return n


def ld_args_blocks_per_sm(kind, model, maxdepth):
    """Chain blocks one SM holds of the ld_args kernel ``kind``
    ("posterior" / "warmup") for ``model`` at its own d and shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    d = model.dim
    tensors = model.hook_parts()[2]
    ints, _ = model_data_args(model, d,
                              tensors[0].device if tensors else "cpu")
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    lib = library(f"nuts_fused_ld_args_{kind}")
    n = getattr(lib, f"nrt_ld_args_{kind}_blocks_per_sm")(
        MODEL_IDS[model.hook_parts()[0]], ctypes.cast(c_ints, ctypes.c_void_p),
        mid_smem_bytes(kind, d, maxdepth, model))
    if n < 0:
        _raise_on(-n, lib, f"nuts_fused_ld_args_{kind} occupancy")
    return n


def count_model(model, stream=False):
    """One launch more of a kernel that evaluated ``model``'s functor (the
    streamed one with ``stream``)."""
    MODEL_LAUNCHES[model.hook_parts()[0] + ("_stream" if stream else "")] += 1


def _raise_on(rc, lib, what):
    if rc != 0:
        msg = lib.nrt_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _jitter_args(jitter):
    if jitter is None:
        return 0, 0.0, 0.0
    return 1, 1.0 - jitter, 2.0 * jitter


def launch_posterior(seed, q, g, logp, stds, mean, logdet, step0, step_bar,
                     K, model, opts, jitter, B):
    """Launch csrc/nuts_fused_posterior.cu; returns (draws [K, d, C],
    stats [K, NSTATS, C], q_f, g_f [C, d], logp_f [C], iters [C])."""
    C, d, D, model_id, params, T = _common(q, model, opts, B,
                                           "nuts_fused_posterior")
    dev = q.device
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    lib = library("nuts_fused_posterior")
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, d, C, **f32)
    stats = torch.empty(K, 13, C, **f32)
    q_f, g_f = torch.empty(C, d, **f32), torch.empty(C, d, **f32)
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_posterior_launch(
            d, D, T, C, B, K, int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, model_id,
            ctypes.cast(params, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), stds.data_ptr(),
            mean.data_ptr(), logdet.data_ptr(), step0.data_ptr(),
            step_bar.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            iters.data_ptr(), stream)
    _raise_on(rc, lib, "nuts_fused_posterior")
    return draws, stats, q_f, g_f, logp_f, iters


def launch_warmup(seed, flags, q, g, logp, stds, mean, est, sca, model, opts,
                  sset, use_grad_based, B):
    """Launch csrc/nuts_fused_warmup.cu; returns (draws [K, d, C],
    stats [K, NSTATS_W, C], q, g, logp, stds, mean, est, sca, iters)."""
    C, d, D, model_id, params, T = _common(q, model, opts, B,
                                           "nuts_fused_warmup")
    dev = q.device
    K = flags.shape[0]
    check_warmup_args(flags, q, g, logp, stds, mean, est, sca)
    lib = library("nuts_fused_warmup")
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, d, C, **f32)
    stats = torch.empty(K, 15, C, **f32)
    outs = [torch.empty(C, d, **f32), torch.empty(C, d, **f32),
            torch.empty(C, **f32), torch.empty(C, d, **f32),
            torch.empty(C, d, **f32), torch.empty(C, 8, d, **f32),
            torch.empty(C, 10, **f32)]
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(sset.jitter)
    da = sset.dual_average
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_warmup_launch(
            d, D, T, C, B, K, int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, int(use_grad_based),
            float(sset.target_accept), float(da.t0), float(da.gamma),
            float(-da.k), math.log(da.max_step_size), model_id,
            ctypes.cast(params, ctypes.c_void_p), flags.data_ptr(),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), stds.data_ptr(),
            mean.data_ptr(), est.data_ptr(), sca.data_ptr(),
            draws.data_ptr(), stats.data_ptr(),
            *(o.data_ptr() for o in outs), iters.data_ptr(), stream)
    _raise_on(rc, lib, "nuts_fused_warmup")
    return (draws, stats, *outs, iters)


def launch_ld_posterior(seed, q, g, logp, stds, mean, logdet, step0,
                        step_bar, K, model, opts, jitter, B):
    """Launch csrc/nuts_fused_ld_posterior.cu; returns (draws [K, C, d],
    stats [K, C, NSTATS], q_f, g_f [C, d], logp_f [C], iters [C])."""
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    C, d, D, model_id, params, work, lib = _ld_common("posterior", q, model,
                                                      opts, B)
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 13, **f32)
    q_f, g_f = torch.empty(C, d, **f32), torch.empty(C, d, **f32)
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_ld_posterior_launch(
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, model_id,
            ctypes.cast(params, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), stds.data_ptr(),
            mean.data_ptr(), logdet.data_ptr(), step0.data_ptr(),
            step_bar.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            iters.data_ptr(), work.data_ptr(), stream)
    _raise_on(rc, lib, "nuts_fused_ld_posterior")
    return draws, stats, q_f, g_f, logp_f, iters


def launch_ld_warmup(seed, flags, q, g, logp, stds, mean, est, sca, model,
                     opts, sset, use_grad_based, B):
    """Launch csrc/nuts_fused_ld_warmup.cu; returns (draws [K, C, d],
    stats [K, C, NSTATS_W], q, g, logp, stds, mean, est, sca, iters).  The
    kernel keeps a chain's current q and g and its estimator planes in the
    output buffers, which start as copies of the inputs."""
    check_warmup_args(flags, q, g, logp, stds, mean, est, sca)
    C, d, D, model_id, params, work, lib = _ld_common("warmup", q, model,
                                                      opts, B)
    dev = q.device
    K = flags.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 15, **f32)
    q_f, g_f, est_f = q.clone(), g.clone(), est.clone()
    logp_f = torch.empty(C, **f32)
    stds_f, mean_f = torch.empty(C, d, **f32), torch.empty(C, d, **f32)
    sca_f = torch.empty(C, 10, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(sset.jitter)
    da = sset.dual_average
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_ld_warmup_launch(
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, int(use_grad_based),
            float(sset.target_accept), float(da.t0), float(da.gamma),
            float(-da.k), math.log(da.max_step_size), model_id,
            ctypes.cast(params, ctypes.c_void_p), flags.data_ptr(),
            logp.data_ptr(), stds.data_ptr(), mean.data_ptr(),
            sca.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            stds_f.data_ptr(), mean_f.data_ptr(), est_f.data_ptr(),
            sca_f.data_ptr(), iters.data_ptr(), work.data_ptr(), stream)
    _raise_on(rc, lib, "nuts_fused_ld_warmup")
    return (draws, stats, q_f, g_f, logp_f, stds_f, mean_f, est_f, sca_f,
            iters)


def launch_mid_posterior(seed, q, g, logp, stds, mean, logdet, step0,
                         step_bar, K, model, opts, jitter, B, family="mid"):
    """Launch csrc/nuts_fused_mid_posterior.cu (``family`` "mid", G chains a
    CUDA block, see ``_mid_common``) or
    csrc/nuts_fused_ld_args_posterior.cu ("ld_args"); returns (draws
    [K, C, d], stats [K, C, NSTATS], q_f, g_f [C, d], logp_f [C],
    iters [C])."""
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    (C, d, D, model_id, params, ptrs, ints, work, lib,
     G) = _mid_common("posterior", q, model, opts, B, family)
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 13, **f32)
    q_f, g_f = torch.empty(C, d, **f32), torch.empty(C, d, **f32)
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"nrt_{family}_posterior_launch")(
            d, D, C, B, *(() if G is None else (G,)), K,
            int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, model_id,
            ctypes.cast(params, ctypes.c_void_p),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), stds.data_ptr(),
            mean.data_ptr(), logdet.data_ptr(), step0.data_ptr(),
            step_bar.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            iters.data_ptr(), work.data_ptr(), stream)
    _raise_on(rc, lib, f"nuts_fused_{family}_posterior")
    return draws, stats, q_f, g_f, logp_f, iters


def flow_packed_floats(d, hidden, n_layers):
    """Floats of a packed coupling flow (csrc/coupling_flow.cuh)."""
    return n_layers * (3 * hidden * d + hidden + 3 * d) + 2 * d


# K1-flow's warp form (csrc/coupling_flow.cuh): d and H up to FLOW_WARP_MAX,
# vectors of FLOW_VEC floats, weight rows at a stride of FLOW_ROW floats (32
# under the ablation macro NRT_FLOW_CONFLICTS)
FLOW_WARP_MAX = 32
FLOW_VEC = 32
FLOW_ROW = 36


def flow_warp_floats(d, hidden, n_layers):
    """Floats of the warp form's shared memory beyond the model functor's
    scratch (csrc/coupling_flow.cuh::flow_warp_floats): 3 to start it on a
    16-byte boundary, five vectors a layer (z, e^s, tanh_s, tanh_t, h) and
    five more (z m, gs, gt, gpre, sacc), then per layer four vectors (mask,
    b1, b2s, b2t) and H + 2 d weight rows, then log sigma and mu and 32
    rows of slack (a lane's row or column past d or H reads there)."""
    row = 32 if "NRT_FLOW_CONFLICTS" in NVCC_DEFINES else FLOW_ROW
    layer = 4 * FLOW_VEC + row * (hidden + 2 * d)
    return (3 + 5 * FLOW_VEC * (n_layers + 1) + n_layers * layer
            + 2 * FLOW_VEC + FLOW_WARP_MAX * row)


def flow_smem_bytes(d, maxdepth, model, n_layers, hidden,
                    weights_in_smem=True, form="today"):
    """Dynamic shared memory of one chain's CUDA block in kernel K1-flow: the
    mid-d posterior layout with the model functor's scratch, then in the
    warp form (``form="warp"``) ``flow_warp_floats``, in today's form the
    flow's work space (the activations of L layers, L (4 d + H) floats,
    four d-vectors and one H-vector) and, with ``weights_in_smem``, the
    packed parameters (csrc/coupling_flow.cuh)."""
    if form == "warp":
        work = flow_warp_floats(d, hidden, n_layers)
    else:
        work = n_layers * (4 * d + hidden) + 4 * d + hidden
        if weights_in_smem:
            work += flow_packed_floats(d, hidden, n_layers)
    return mid_smem_bytes("posterior", d, maxdepth, model) + 4 * work


def flow_form(d, maxdepth, model, n_layers, hidden):
    """The form of K1-flow's flow at these shapes: "warp" (both passes on
    one warp, no block barrier inside them) where d <= 32 and H <= 32 and
    its layout fits a block's shared memory, else "today" (every thread of
    the block; the parameters in shared memory where they fit, else read
    through L2).  csrc/coupling_flow.cuh::flow_kernel_form is the same rule;
    under the ablation macro NRT_FLOW_TODAY every flow takes today's form.
    Not a fallback: a launch in the form chosen raises where it fails."""
    if "NRT_FLOW_TODAY" in NVCC_DEFINES:
        return "today"
    fits = flow_smem_bytes(d, maxdepth, model, n_layers, hidden,
                           form="warp") <= SMEM_OPT_IN_BYTES
    return ("warp" if d <= FLOW_WARP_MAX and hidden <= FLOW_WARP_MAX and fits
            else "today")


def _flow_layout(d, maxdepth, model, n_layers, hidden):
    """(form, parameters in shared memory, bytes of shared memory) of a
    K1-flow launch: the warp form keeps its parameters there, today's where
    they fit beside the chain's state."""
    form = flow_form(d, maxdepth, model, n_layers, hidden)
    in_smem = form == "warp" or flow_smem_bytes(
        d, maxdepth, model, n_layers, hidden) <= SMEM_OPT_IN_BYTES
    return form, in_smem, flow_smem_bytes(d, maxdepth, model, n_layers,
                                          hidden, in_smem, form)


def flow_blocks_per_sm(model, maxdepth, n_layers, hidden):
    """(form, chain blocks of K1-flow one SM holds) for ``model`` at its own
    d through a flow of ``n_layers`` x ``hidden``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    d = model.dim
    form, _, smem = _flow_layout(d, maxdepth, model, n_layers, hidden)
    name, ints = _hook_ints(model, d)
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    lib = library(FLOW_LIBRARIES[form])
    n = lib.nrt_flow_blocks_per_sm(int(form == "warp"), MODEL_IDS[name],
                                   ctypes.cast(c_ints, ctypes.c_void_p), smem)
    if n < 0:
        _raise_on(-n, lib, f"{FLOW_LIBRARIES[form]} occupancy")
    return form, n


def check_flow_args(packed, d, device):
    """Check every array of a packed coupling flow (``flows/coupling.py::
    PackedFlow``): float32, contiguous, on ``device``, in the shapes of its
    layout, the same hidden width in every layer.  Returns (layers,
    hidden)."""
    arrays = list(packed.arrays)
    if len(arrays) < 2 or (len(arrays) - 2) % 7:
        raise ValueError("a packed flow holds 7 arrays a layer and "
                         "log_sigma, mu")
    L = (len(arrays) - 2) // 7
    H = int(arrays[1].shape[0]) if L else 1
    if H < 1:
        raise ValueError("a coupling layer needs at least one hidden unit")
    shapes = [(d, 1), (H, d), (H, 1), (d, H), (d, 1), (d, H), (d, 1)] * L
    shapes += [(d, 1), (d, 1)]
    names = ["mask", "w1T", "b1", "w2sT", "b2s", "w2tT", "b2t"] * L
    names += ["log_sigma", "mu"]
    for i, (name, a, shape) in enumerate(zip(names, arrays, shapes)):
        check_tensor(f"flow array {i} ({name})", a, shape, device)
    return L, H


def launch_flow_posterior(seed, q, g, logp, stds, mean, logdet, step0,
                          step_bar, K, model, opts, jitter, B, flow):
    """Launch kernel K1-flow (csrc/nuts_fused_flow_posterior.cuh, from the
    library of its flow's form, ``FLOW_LIBRARIES``): ``q``
    carries z0, ``flow`` is a PackedFlow of arrays on the card; returns
    (draws [K, C, d], stats [K, C, NSTATS], q_f, z_f [C, d], logp_f [C],
    iters [C]).  The flow takes the form ``flow_form`` picks: the warp form
    with its own layout of the parameters in shared memory, or today's,
    whose parameters go into each block's shared memory where they fit
    beside the chain's state, else are read through L2; a chain whose state
    and the flow's work space do not fit a block is refused."""
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    model_id, params = _model_and_block(q, model, B, MAX_LD_BLOCK)
    C, d = q.shape
    D = opts.maxdepth
    if not 1 <= D <= LD_MAX_MAXDEPTH:
        raise NotImplementedError(
            f"kernel K1-flow takes maxdepth 1..{LD_MAX_MAXDEPTH}, got {D}")
    L, H = check_flow_args(flow, d, q.device)
    ints, ptrs = model_data_args(model, d, q.device)
    form, in_smem, need = _flow_layout(d, D, model, L, H)
    if need > SMEM_OPT_IN_BYTES:
        raise NotImplementedError(
            f"kernel K1-flow at dim {d} with {L} layers of {H} needs {need} "
            f"bytes of shared memory per chain without the parameters; a "
            f"block has {SMEM_OPT_IN_BYTES}")
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    c_ptrs = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    lib = library(FLOW_LIBRARIES[form])
    p_ints = ctypes.cast(c_ints, ctypes.c_void_p)
    built = lib.nrt_flow_smem_bytes(d, D, model_id, p_ints, L, H,
                                    int(form == "warp"), int(in_smem))
    built_form = lib.nrt_flow_form(d, D, model_id, p_ints, L, H)
    if built != need or built_form != int(form == "warp"):
        raise RuntimeError(f"csrc lays out {built} bytes of shared memory "
                           f"for kernel K1-flow in form {built_form}, "
                           f"_build.flow_smem_bytes {need} in form {form!r}")
    packed = torch.cat([a.reshape(-1) for a in flow.arrays])
    work = torch.empty(C, 4, D + 1, d, dtype=torch.float32, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 13, **f32)
    q_f, z_f = torch.empty(C, d, **f32), torch.empty(C, d, **f32)
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=q.device)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.nrt_flow_posterior_launch(
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, model_id, L, H,
            float(flow.max_scale), float(flow.max_shift),
            int(form == "warp"), int(in_smem),
            ctypes.cast(params, ctypes.c_void_p),
            ctypes.cast(c_ptrs, ctypes.c_void_p),
            ctypes.cast(c_ints, ctypes.c_void_p), packed.data_ptr(),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), stds.data_ptr(),
            mean.data_ptr(), logdet.data_ptr(), step0.data_ptr(),
            step_bar.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), z_f.data_ptr(), logp_f.data_ptr(),
            iters.data_ptr(), work.data_ptr(), stream)
    _raise_on(rc, lib, FLOW_LIBRARIES[form])
    FLOW_FORM_LAUNCHES[form] += 1
    return draws, stats, q_f, z_f, logp_f, iters


def launch_stream_posterior(seed, q, g, logp, stds, mean, logdet, step0,
                            step_bar, K, model, opts, jitter, B, R):
    """Launch csrc/nuts_fused_stream_posterior.cu (kernel K1-stream) on the
    hook tensors of ``model`` in tiles of ``model.stream_tile_rows`` rows,
    in logical blocks of ``B`` chains (one cooperative grid of B CUDA
    blocks, all resident at once) and ``R`` ranges of tiles; returns
    (draws [K, C, d], stats [K, C, NSTATS], q_f, g_f [C, d], logp_f [C],
    iters [C]).  A block that cannot be resident at once, or a launch that
    CUDA refuses, raises with the CUDA error; nothing is launched then."""
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    _model_and_block(q, model, 1)
    name = model.hook_parts()[0] + "_stream"
    rows = model.stream_tile_rows
    if name not in MODEL_IDS or rows is None or rows < 1:
        raise NotImplementedError(
            f"model {model.name!r} has no streamed functor the CUDA kernels "
            "compile in: as in the JAX package, only the logistic "
            "regression streams its data")
    model_id = MODEL_IDS[name]
    C, d = q.shape
    D = opts.maxdepth
    if not 1 <= D <= LD_MAX_MAXDEPTH:
        raise NotImplementedError(
            f"the streamed CUDA kernel takes maxdepth 1..{LD_MAX_MAXDEPTH}, "
            f"got {D}")
    ints, ptrs = model_data_args(model, d, q.device)
    T = -(-ints[0] // rows)
    if not 1 <= B or C % B:
        raise ValueError(f"chain block {B} must divide num_chains ({C})")
    if not 1 <= R <= T:
        raise ValueError(f"ranges must be 1..{T} (the tiles), got {R}")
    S, CG = stream_tiling(d, B, D)
    ints = (*ints, int(rows), int(R), S, CG)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lib = library("nuts_fused_stream_posterior")
    need = stream_smem_bytes(d, D, S, CG)
    built = lib.nrt_stream_smem_bytes(d, D, model_id,
                                      ctypes.cast(c_ints, ctypes.c_void_p))
    if built != need:
        raise RuntimeError(f"csrc lays out {built} bytes of shared memory "
                           "for the streamed kernel, "
                           f"_build.stream_smem_bytes {need}")
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    work = torch.empty(C, 4, D + 1, d, **f32)
    space = torch.empty(stream_workspace_floats(R, B, d), **f32)
    pos, part = space[:d * B], space[d * B:]
    sync = torch.zeros(2 + B, dtype=torch.int32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 13, **f32)
    q_f, g_f = torch.empty(C, d, **f32), torch.empty(C, d, **f32)
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_stream_posterior_launch(
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, model_id,
            ctypes.cast(c_ptrs, ctypes.c_void_p),
            ctypes.cast(c_ints, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), stds.data_ptr(),
            mean.data_ptr(), logdet.data_ptr(), step0.data_ptr(),
            step_bar.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            iters.data_ptr(), work.data_ptr(), pos.data_ptr(),
            part.data_ptr(), sync.data_ptr(), stream)
    _raise_on(rc, lib, "nuts_fused_stream_posterior")
    return draws, stats, q_f, g_f, logp_f, iters


def launch_mid_warmup(seed, flags, q, g, logp, stds, mean, est, sca, model,
                      opts, sset, use_grad_based, B, family="mid"):
    """Launch csrc/nuts_fused_mid_warmup.cu (``family`` "mid", G chains a
    CUDA block, see ``_mid_common``) or
    csrc/nuts_fused_ld_args_warmup.cu ("ld_args"); returns (draws
    [K, C, d], stats [K, C, NSTATS_W], q, g, logp, stds, mean, est, sca,
    iters).  As the ld warmup kernel, it keeps a chain's current q and g and
    its estimator planes in the output buffers, which start as copies of the
    inputs."""
    check_warmup_args(flags, q, g, logp, stds, mean, est, sca)
    (C, d, D, model_id, params, ptrs, ints, work, lib,
     G) = _mid_common("warmup", q, model, opts, B, family)
    dev = q.device
    K = flags.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 15, **f32)
    q_f, g_f, est_f = q.clone(), g.clone(), est.clone()
    logp_f = torch.empty(C, **f32)
    stds_f, mean_f = torch.empty(C, d, **f32), torch.empty(C, d, **f32)
    sca_f = torch.empty(C, 10, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(sset.jitter)
    da = sset.dual_average
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"nrt_{family}_warmup_launch")(
            d, D, C, B, *(() if G is None else (G,)), K,
            int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, int(use_grad_based),
            float(sset.target_accept), float(da.t0), float(da.gamma),
            float(-da.k), math.log(da.max_step_size), model_id,
            ctypes.cast(params, ctypes.c_void_p),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints, ctypes.c_void_p), flags.data_ptr(),
            logp.data_ptr(), stds.data_ptr(), mean.data_ptr(),
            sca.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            stds_f.data_ptr(), mean_f.data_ptr(), est_f.data_ptr(),
            sca_f.data_ptr(), iters.data_ptr(), work.data_ptr(), stream)
    _raise_on(rc, lib, f"nuts_fused_{family}_warmup")
    return (draws, stats, q_f, g_f, logp_f, stds_f, mean_f, est_f, sca_f,
            iters)


def launch_mclmc_posterior(seed, q, g, logp, v, stds, mean, logdet, step0,
                           step_bar, K, model, mopts, jitter, B):
    """Launch csrc/mclmc_fused_posterior.cu; returns (draws [K, d, C],
    stats [K, 8, C], q_f, g_f [C, d], logp_f [C], v_f [C, d], iters [C])."""
    C, d, model_id, params, consts, fconsts = _mclmc_common(q, model, mopts,
                                                            B)
    dev = q.device
    check_mclmc_posterior_args(q, g, logp, v, stds, mean, logdet, step0,
                               step_bar, K, mopts)
    lib = library("mclmc_fused_posterior")
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, d, C, **f32)
    stats = torch.empty(K, 8, C, **f32)
    q_f, g_f, v_f = (torch.empty(C, d, **f32) for _ in range(3))
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_mclmc_posterior_launch(
            d, *consts, C, B, K, int(seed) & 0xFFFFFFFF, *fconsts, hj, jc1,
            jc2, model_id, ctypes.cast(params, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), v.data_ptr(),
            stds.data_ptr(), mean.data_ptr(), logdet.data_ptr(),
            step0.data_ptr(), step_bar.data_ptr(), draws.data_ptr(),
            stats.data_ptr(), q_f.data_ptr(), g_f.data_ptr(),
            logp_f.data_ptr(), v_f.data_ptr(), iters.data_ptr(), stream)
    _raise_on(rc, lib, "mclmc_fused_posterior")
    return draws, stats, q_f, g_f, logp_f, v_f, iters


def launch_mclmc_warmup(seed, flags, q, g, logp, v, stds, mean, est, sca,
                        model, mopts, sset, use_grad_based, B):
    """Launch csrc/mclmc_fused_warmup.cu; returns (draws [K, d, C],
    stats [K, 9, C], q, g, logp, v, stds, mean, est, sca, iters)."""
    C, d, model_id, params, consts, fconsts = _mclmc_common(q, model, mopts,
                                                            B)
    dev = q.device
    K = flags.shape[0]
    check_mclmc_warmup_args(flags, q, g, logp, v, stds, mean, est, sca,
                            mopts)
    lib = library("mclmc_fused_warmup")
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, d, C, **f32)
    stats = torch.empty(K, 9, C, **f32)
    outs = [torch.empty(C, d, **f32), torch.empty(C, d, **f32),
            torch.empty(C, **f32), torch.empty(C, d, **f32),
            torch.empty(C, d, **f32), torch.empty(C, d, **f32),
            torch.empty(C, 8, d, **f32), torch.empty(C, 4, **f32)]
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(sset.jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_mclmc_warmup_launch(
            d, *consts, C, B, K, int(seed) & 0xFFFFFFFF, *fconsts,
            float(sset.fixed_value), hj, jc1, jc2, int(use_grad_based),
            model_id, ctypes.cast(params, ctypes.c_void_p), flags.data_ptr(),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), v.data_ptr(),
            stds.data_ptr(), mean.data_ptr(), est.data_ptr(), sca.data_ptr(),
            draws.data_ptr(), stats.data_ptr(),
            *(o.data_ptr() for o in outs), iters.data_ptr(), stream)
    _raise_on(rc, lib, "mclmc_fused_warmup")
    return (draws, stats, *outs, iters)


def launch_mclmc_mid_posterior(seed, q, g, logp, v, stds, mean, logdet, step0,
                               step_bar, K, model, mopts, jitter, B):
    """Launch csrc/mclmc_fused_mid_posterior.cu; returns (draws [K, C, d],
    stats [K, C, 8], q_f, g_f [C, d], logp_f [C], v_f [C, d], iters [C])."""
    check_mclmc_posterior_args(q, g, logp, v, stds, mean, logdet, step0,
                               step_bar, K, mopts)
    (C, d, model_id, params, ptrs, ints, consts, fconsts, lib,
     form) = _mclmc_mid_common("posterior", q, model, mopts, B)
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 8, **f32)
    q_f, g_f, v_f = (torch.empty(C, d, **f32) for _ in range(3))
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_mclmc_mid_posterior_launch(
            d, *consts, C, B, K, int(seed) & 0xFFFFFFFF, *fconsts, hj, jc1,
            jc2, model_id, ctypes.cast(params, ctypes.c_void_p),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), v.data_ptr(),
            stds.data_ptr(), mean.data_ptr(), logdet.data_ptr(),
            step0.data_ptr(), step_bar.data_ptr(), draws.data_ptr(),
            stats.data_ptr(), q_f.data_ptr(), g_f.data_ptr(),
            logp_f.data_ptr(), v_f.data_ptr(), iters.data_ptr(), stream)
    _raise_on(rc, lib, "mclmc_fused_mid_posterior")
    MCLMC_BLOCK_FORM_LAUNCHES[f"posterior {block_form_name(form)}"] += 1
    return draws, stats, q_f, g_f, logp_f, v_f, iters


def launch_mclmc_mid_warmup(seed, flags, q, g, logp, v, stds, mean, est, sca,
                            model, mopts, sset, use_grad_based, B):
    """Launch csrc/mclmc_fused_mid_warmup.cu; returns (draws [K, C, d],
    stats [K, C, 9], q, g, logp, v, stds, mean, est, sca, iters).  As the ld
    NUTS warmup kernel, it keeps a chain's current q and g and its estimator
    planes in the output buffers, which start as copies of the inputs."""
    check_mclmc_warmup_args(flags, q, g, logp, v, stds, mean, est, sca,
                            mopts)
    (C, d, model_id, params, ptrs, ints, consts, fconsts, lib,
     form) = _mclmc_mid_common("warmup", q, model, mopts, B)
    dev = q.device
    K = flags.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 9, **f32)
    q_f, g_f, est_f = q.clone(), g.clone(), est.clone()
    # the pair form's second block keeps its own copies (mclmc_fused_mid_
    # warmup.cu); null pointers elsewhere
    pair = ((q.clone(), g.clone(), est.clone()) if form[1] == 2
            else (None, None, None))
    logp_f = torch.empty(C, **f32)
    v_f, stds_f, mean_f = (torch.empty(C, d, **f32) for _ in range(3))
    sca_f = torch.empty(C, 4, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(sset.jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_mclmc_mid_warmup_launch(
            d, *consts, C, B, K, int(seed) & 0xFFFFFFFF, *fconsts,
            float(sset.fixed_value), hj, jc1, jc2, int(use_grad_based),
            model_id, ctypes.cast(params, ctypes.c_void_p),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints, ctypes.c_void_p), flags.data_ptr(),
            logp.data_ptr(), v.data_ptr(), stds.data_ptr(), mean.data_ptr(),
            sca.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            v_f.data_ptr(), stds_f.data_ptr(), mean_f.data_ptr(),
            est_f.data_ptr(), sca_f.data_ptr(), iters.data_ptr(),
            *(None if t is None else t.data_ptr() for t in pair), stream)
    _raise_on(rc, lib, "mclmc_fused_mid_warmup")
    MCLMC_BLOCK_FORM_LAUNCHES[f"warmup {block_form_name(form)}"] += 1
    return (draws, stats, q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f,
            iters)


def launch_mclmc_group_posterior(seed, q, g, logp, v, stds, mean, logdet,
                                 step0, step_bar, K, model, mopts, jitter, B):
    """Launch csrc/mclmc_fused_group_posterior.cu (the regression under the
    microcanonical dynamics); returns what ``launch_mclmc_mid_posterior``
    returns."""
    check_mclmc_posterior_args(q, g, logp, v, stds, mean, logdet, step0,
                               step_bar, K, mopts)
    (C, d, G, ptrs, ints, dynamic, fconsts,
     lib) = _mclmc_group_common("posterior", q, model, mopts, B)
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 8, **f32)
    q_f, g_f, v_f = (torch.empty(C, d, **f32) for _ in range(3))
    logp_f = torch.empty(C, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_mclmc_group_posterior_launch(
            d, dynamic, C, B, G, K, int(seed) & 0xFFFFFFFF, *fconsts, hj,
            jc1, jc2, ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), v.data_ptr(),
            stds.data_ptr(), mean.data_ptr(), logdet.data_ptr(),
            step0.data_ptr(), step_bar.data_ptr(), draws.data_ptr(),
            stats.data_ptr(), q_f.data_ptr(), g_f.data_ptr(),
            logp_f.data_ptr(), v_f.data_ptr(), iters.data_ptr(), stream)
    _raise_on(rc, lib, "mclmc_fused_group_posterior")
    return draws, stats, q_f, g_f, logp_f, v_f, iters


def launch_mclmc_group_warmup(seed, flags, q, g, logp, v, stds, mean, est,
                              sca, model, mopts, sset, use_grad_based, B):
    """Launch csrc/mclmc_fused_group_warmup.cu (the regression under the
    microcanonical dynamics); returns what ``launch_mclmc_mid_warmup``
    returns, its q, g and estimator planes kept in the output buffers as
    there."""
    check_mclmc_warmup_args(flags, q, g, logp, v, stds, mean, est, sca,
                            mopts)
    (C, d, G, ptrs, ints, dynamic, fconsts,
     lib) = _mclmc_group_common("warmup", q, model, mopts, B)
    dev = q.device
    K = flags.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    draws = torch.empty(K, C, d, **f32)
    stats = torch.empty(K, C, 9, **f32)
    q_f, g_f, est_f = q.clone(), g.clone(), est.clone()
    logp_f = torch.empty(C, **f32)
    v_f, stds_f, mean_f = (torch.empty(C, d, **f32) for _ in range(3))
    sca_f = torch.empty(C, 4, **f32)
    iters = torch.empty(C, dtype=torch.int32, device=dev)
    hj, jc1, jc2 = _jitter_args(sset.jitter)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrt_mclmc_group_warmup_launch(
            d, dynamic, C, B, G, K, int(seed) & 0xFFFFFFFF, *fconsts,
            float(sset.fixed_value), hj, jc1, jc2, int(use_grad_based),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints, ctypes.c_void_p), flags.data_ptr(),
            logp.data_ptr(), v.data_ptr(), stds.data_ptr(), mean.data_ptr(),
            sca.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            v_f.data_ptr(), stds_f.data_ptr(), mean_f.data_ptr(),
            est_f.data_ptr(), sca_f.data_ptr(), iters.data_ptr(), stream)
    _raise_on(rc, lib, "mclmc_fused_group_warmup")
    return (draws, stats, q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f,
            iters)
