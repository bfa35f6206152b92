"""Build, load and launch the hand-written CUDA kernels.

No counterpart in the JAX package (Pallas compiles inside ``pallas_call``).
On first use, every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, under
``nuts_rs_tpu_torch/_build/`` (named by a hash of the sources and flags, so
an edited source rebuilds), and loaded with ``ctypes``.  The launchers
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
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..dynamics.hamiltonian import KineticKind

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# (d, maxdepth) instantiations of the thread-per-chain chains-on-lanes NUTS
# kernels; other sizes up to ``CL_THREAD_MAX_DIM`` raise.  The MCLMC kernels
# are instantiated for the same d (``DIMS``), both kinetic energies and both
# settings of ``dynamic_step_size``.  The mid-d chains-on-lanes kernels, NUTS
# and MCLMC (above ``CL_THREAD_MAX_DIM``, and every model with data), and the
# dim-on-lanes (ld) NUTS kernels take d (and maxdepth) at run time.
SIZES = tuple((d, 10) for d in (3, 4, 6, 10))
DIMS = tuple(sorted({d for d, _ in SIZES}))
CL_THREAD_MAX_DIM = max(DIMS)
# nrt::ModelId of each kernel hook name (csrc/models.cuh)
MODEL_IDS = {"iid_normal": 0, "logistic_regression": 1}
MAX_BLOCK = 128  # nrt::MAX_BLOCK, the kernels' __launch_bounds__
# ld kernels: chains per logical block = CUDA blocks per cluster
# (nrt::LD_MAX_CLUSTER, the portable cluster size); live vectors a chain
# keeps in shared memory (nrt::LD_POST_NVEC / LD_WARM_NVEC) and the dynamic
# shared memory a block may opt in to on sm_90.
MAX_LD_BLOCK = 8
LD_NVEC = {"posterior": 21, "warmup": 18}
MID_NVEC = {"posterior": 21, "warmup": 19}  # the warmup keeps q1 as well
MCLMC_MID_NVEC = 15  # nrt::MC_MID_NVEC, both mid-d MCLMC kernels
LD_WARPS = 8  # nrt::LD_W, warps of a chain's block (ops.TSUM_THREADS / 32)
LD_REDUCE_FLOATS = 2 * 11 * LD_WARPS  # two scratch buffers, LD_NRED x LD_W
LD_MAX_MAXDEPTH = 30
SMEM_OPT_IN_BYTES = 232448
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_LIB = None
BUILD_INFO = {}


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


def library():
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256()
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(_sizes_header().encode())
    so = BUILD_DIR / f"libnuts_fused_{h.hexdigest()[:16]}.so"
    t0 = time.monotonic()
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        (BUILD_DIR / "nrt_sizes.h").write_text(_sizes_header())
        nvcc = _nvcc()
        objs, procs = [], []
        for src in sources:
            obj = BUILD_DIR / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c",
                 "-I", str(BUILD_DIR), "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp = so.with_suffix(".tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        tmp.replace(so)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
    BUILD_INFO["seconds"] = time.monotonic() - t0
    BUILD_INFO["library"] = str(so)
    lib = ctypes.CDLL(str(so))
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.nrt_posterior_launch.argtypes = (
        [I, I, I, I, I, U, F, I, F, F, I] + [P] * 15 + [P])
    lib.nrt_posterior_launch.restype = I
    lib.nrt_warmup_launch.argtypes = (
        [I, I, I, I, I, U, F, I, F, F, I, F, F, F, F, F, I] + [P] * 19
        + [P])
    lib.nrt_warmup_launch.restype = I
    lib.nrt_mclmc_posterior_launch.argtypes = (
        [I, I, I, I, I, I, U, F, F, F, F, I, F, F, I] + [P] * 17 + [P])
    lib.nrt_mclmc_posterior_launch.restype = I
    lib.nrt_mclmc_warmup_launch.argtypes = (
        [I, I, I, I, I, I, U, F, F, F, F, F, I, F, F, I, I] + [P] * 21
        + [P])
    lib.nrt_mclmc_warmup_launch.restype = I
    lib.nrt_ld_posterior_launch.argtypes = (
        [I, I, I, I, I, U, F, I, F, F, I] + [P] * 16 + [P])
    lib.nrt_ld_posterior_launch.restype = I
    lib.nrt_ld_warmup_launch.argtypes = (
        [I, I, I, I, I, U, F, I, F, F, I, F, F, F, F, F, I] + [P] * 17
        + [P])
    lib.nrt_ld_warmup_launch.restype = I
    lib.nrt_ld_smem_bytes.argtypes = [I, I, I]
    lib.nrt_ld_smem_bytes.restype = ctypes.c_longlong
    lib.nrt_mid_posterior_launch.argtypes = (
        [I, I, I, I, I, U, F, I, F, F, I] + [P] * 18 + [P])
    lib.nrt_mid_posterior_launch.restype = I
    lib.nrt_mid_warmup_launch.argtypes = (
        [I, I, I, I, I, U, F, I, F, F, I, F, F, F, F, F, I] + [P] * 19
        + [P])
    lib.nrt_mid_warmup_launch.restype = I
    lib.nrt_mid_smem_bytes.argtypes = [I, I, I, I, P]
    lib.nrt_mid_smem_bytes.restype = ctypes.c_longlong
    lib.nrt_mclmc_mid_posterior_launch.argtypes = (
        [I, I, I, I, I, I, U, F, F, F, F, I, F, F, I] + [P] * 19 + [P])
    lib.nrt_mclmc_mid_posterior_launch.restype = I
    lib.nrt_mclmc_mid_warmup_launch.argtypes = (
        [I, I, I, I, I, I, U, F, F, F, F, F, I, F, F, I, I] + [P] * 20
        + [P])
    lib.nrt_mclmc_mid_warmup_launch.restype = I
    lib.nrt_mclmc_mid_smem_bytes.argtypes = [I, I, P]
    lib.nrt_mclmc_mid_smem_bytes.restype = ctypes.c_longlong
    lib.nrt_error_string.argtypes = [I]
    lib.nrt_error_string.restype = ctypes.c_char_p
    _LIB = lib
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


def _common(q, model, opts, B):
    model_id, params = _model_and_block(q, model, B)
    C, d = q.shape
    D = opts.maxdepth
    if (d, D) not in SIZES:
        raise NotImplementedError(
            f"the fused CUDA kernels are instantiated for (d, maxdepth) in "
            f"{SIZES}, not ({d}, {D}) (ROADMAP.md queue 1 item 12)")
    return C, d, D, model_id, params


def _model_and_block(q, model, B, max_block=MAX_BLOCK, data=False):
    """(model id, params) of the kernel hook, after the device and block
    checks.  ``data``: the kernel reads the hook's tensors (only the mid-d
    kernels do)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {q.device}")
    C = q.shape[0]
    if model.kernel_hook is None or model.hook_parts()[0] not in MODEL_IDS:
        raise NotImplementedError(
            f"model {model.name!r} has no kernel hook the CUDA kernels "
            "compile in (ROADMAP.md queue 1 item 10)")
    name, floats, tensors = model.hook_parts()
    if tensors and not data:
        raise NotImplementedError(
            f"model {model.name!r} carries data, which only the mid-d "
            "chains-on-lanes kernels read (ROADMAP.md queue 1 item 12)")
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
        raise ValueError("iid_normal carries no data")
    return ()


# per kernel hook name: (the check of its tensors, which returns the ints
# the functor takes; the functor's shared-memory scratch in floats from
# those ints), as csrc/models.cuh::with_block_model and scratch_floats
_MODEL_DATA = {
    "iid_normal": (_no_data, lambda ints: 0),
    "logistic_regression": (_logistic_regression_data,
                            lambda ints: ints[0] + LD_WARPS * ints[1]),
}


def model_data_args(model, d, device):
    """(ints, ptrs) of a model's hook tensors for a mid-d launch, after the
    functor's own check of them on ``device``."""
    name, _, tensors = model.hook_parts()
    ints = _MODEL_DATA[name][0](tensors, d, torch.device(device))
    return ints, [t.data_ptr() for t in tensors]


def mid_smem_bytes(kind, d, maxdepth, model):
    """Dynamic shared memory of one chain's CUDA block in the mid-d kernel
    ``kind`` ("posterior" / "warmup"): the dim-on-lanes layout of
    ``ld_smem_bytes`` with ``MID_NVEC`` vectors, then the model functor's
    scratch, whose size comes from the functor's check of the model's data
    where they lie."""
    return 4 * (MID_NVEC[kind] * d + 2 * (maxdepth + 1) + LD_REDUCE_FLOATS
                + 2 * MAX_LD_BLOCK + _scratch_floats(model, d))


def _scratch_floats(model, d):
    """Shared-memory floats of a model functor's scratch, from the functor's
    check of the model's data where they lie."""
    name, _, tensors = model.hook_parts()
    ints = _MODEL_DATA[name][0](tensors, d, tensors[0].device if tensors
                                else None)
    return _MODEL_DATA[name][1](ints)


def mclmc_mid_smem_bytes(d, model):
    """Dynamic shared memory of one chain's CUDA block in either mid-d MCLMC
    kernel, as csrc/mclmc_step_block.cuh lays it out: the live vectors, the
    reduction scratch and the cluster slots, then the model functor's
    scratch.  No checkpoint stacks, so nothing depends on a depth."""
    return 4 * (MCLMC_MID_NVEC * d + LD_REDUCE_FLOATS + 2 * MAX_LD_BLOCK
                + _scratch_floats(model, d))


def _mclmc_consts(d, mopts):
    """The dynamics' template flags (microcanonical, dynamic step size) and
    f32 constants (max_energy_error, L, F L, sqrt(d)) of an MCLMC launch."""
    L = float(mopts.momentum_decoherence_length)
    consts = (int(mopts.kind is KineticKind.MICROCANONICAL),
              int(mopts.dynamic_step_size))
    fconsts = (float(mopts.max_energy_error), L,
               float(mopts.subsample_frequency) * L, math.sqrt(d))
    return consts, fconsts


def _mclmc_common(q, model, mopts, B):
    model_id, params = _model_and_block(q, model, B)
    C, d = q.shape
    if d not in DIMS:
        raise NotImplementedError(
            f"the thread-per-chain MCLMC kernels are instantiated for d in "
            f"{DIMS}, not {d} (ROADMAP.md queue 1 item 12)")
    consts, fconsts = _mclmc_consts(d, mopts)
    return C, d, model_id, params, consts, fconsts


def _mclmc_mid_common(q, model, mopts, B):
    """(C, d, model id, params, ptrs, ints, consts, fconsts, lib) of a mid-d
    MCLMC launch, after the device, block, size and data checks."""
    model_id, params = _model_and_block(q, model, B, MAX_LD_BLOCK, data=True)
    C, d = q.shape
    ints, ptrs = model_data_args(model, d, q.device)
    need = mclmc_mid_smem_bytes(d, model)
    if need > SMEM_OPT_IN_BYTES:
        raise NotImplementedError(
            f"model {model.name!r} at dim {d} needs {need} bytes of shared "
            f"memory per chain in the mid-d MCLMC kernels; a block has "
            f"{SMEM_OPT_IN_BYTES}: data of that size must stream (ROADMAP.md "
            "queue 1 item 12)")
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    c_ptrs = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    lib = library()
    built = lib.nrt_mclmc_mid_smem_bytes(
        d, model_id, ctypes.cast(c_ints, ctypes.c_void_p))
    if built != need:
        raise RuntimeError(f"csrc lays out {built} bytes of shared memory "
                           "for the mid-d MCLMC kernels, "
                           f"_build.mclmc_mid_smem_bytes {need}")
    consts, fconsts = _mclmc_consts(d, mopts)
    return C, d, model_id, params, c_ptrs, c_ints, consts, fconsts, lib


def ld_smem_bytes(kind, d, maxdepth):
    """Dynamic shared memory of one chain's CUDA block in the ld kernel
    ``kind`` ("posterior" / "warmup"), as csrc/nuts_tree_ld.cuh lays it out:
    the live vectors, the two cached-dot rows, the reduction scratch and
    the cluster slots."""
    return 4 * (LD_NVEC[kind] * d + 2 * (maxdepth + 1) + LD_REDUCE_FLOATS
                + 2 * MAX_LD_BLOCK)


def ld_max_dim(maxdepth):
    """Largest d whose chain state fits a block's shared memory in both ld
    kernels."""
    nvec = max(LD_NVEC.values())
    return (SMEM_OPT_IN_BYTES - ld_smem_bytes("posterior", 0, maxdepth)) \
        // (4 * nvec)


def _ld_common(kind, q, model, opts, B):
    """(C, d, D, model id, params, workspace) of an ld launch, after the
    device, block and size checks.  The workspace holds the four checkpoint
    stacks of every chain, [C, 4, D + 1, d]; the kernels write a row before
    they read it, so it is not cleared."""
    model_id, params = _model_and_block(q, model, B, MAX_LD_BLOCK)
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
    lib = library()
    built = lib.nrt_ld_smem_bytes(int(kind == "warmup"), d, D)
    if built != need:
        raise RuntimeError(f"csrc/nuts_tree_ld.cuh lays out {built} bytes of "
                           f"shared memory, _build.ld_smem_bytes {need}")
    work = torch.empty(C, 4, D + 1, d, dtype=torch.float32, device=q.device)
    return C, d, D, model_id, params, work, lib


def _mid_common(kind, q, model, opts, B):
    """(C, d, D, model id, params, ptrs, ints, workspace, lib) of a mid-d
    launch, after the device, block, size and data checks.  ``ptrs`` and
    ``ints`` are ctypes arrays of the hook tensors' device pointers and of
    the sizes their functor takes."""
    model_id, params = _model_and_block(q, model, B, MAX_LD_BLOCK, data=True)
    C, d = q.shape
    D = opts.maxdepth
    if not 1 <= D <= LD_MAX_MAXDEPTH:
        raise NotImplementedError(
            f"the mid-d CUDA kernels take maxdepth 1..{LD_MAX_MAXDEPTH}, "
            f"got {D}")
    ints, ptrs = model_data_args(model, d, q.device)
    need = mid_smem_bytes(kind, d, D, model)
    if need > SMEM_OPT_IN_BYTES:
        raise NotImplementedError(
            f"model {model.name!r} at dim {d} needs {need} bytes of shared "
            f"memory per chain in the mid-d {kind} kernel; a block has "
            f"{SMEM_OPT_IN_BYTES}: data of that size must stream (kernel "
            "K1-stream, ROADMAP.md queue 1 item 12)")
    c_ints = (ctypes.c_int * max(1, len(ints)))(*ints)
    c_ptrs = (ctypes.c_void_p * max(1, len(ptrs)))(*ptrs)
    lib = library()
    built = lib.nrt_mid_smem_bytes(int(kind == "warmup"), d, D, model_id,
                                   ctypes.cast(c_ints, ctypes.c_void_p))
    if built != need:
        raise RuntimeError(f"csrc lays out {built} bytes of shared memory "
                           f"for the mid-d {kind} kernel, "
                           f"_build.mid_smem_bytes {need}")
    work = torch.empty(C, 4, D + 1, d, dtype=torch.float32, device=q.device)
    return C, d, D, model_id, params, c_ptrs, c_ints, work, lib


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
    C, d, D, model_id, params = _common(q, model, opts, B)
    dev = q.device
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    lib = library()
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
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
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
    C, d, D, model_id, params = _common(q, model, opts, B)
    dev = q.device
    K = flags.shape[0]
    check_warmup_args(flags, q, g, logp, stds, mean, est, sca)
    lib = library()
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
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
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
                         step_bar, K, model, opts, jitter, B):
    """Launch csrc/nuts_fused_mid_posterior.cu; returns (draws [K, C, d],
    stats [K, C, NSTATS], q_f, g_f [C, d], logp_f [C], iters [C])."""
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar, K)
    (C, d, D, model_id, params, ptrs, ints, work,
     lib) = _mid_common("posterior", q, model, opts, B)
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
        rc = lib.nrt_mid_posterior_launch(
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
            float(opts.max_energy_error), hj, jc1, jc2, model_id,
            ctypes.cast(params, ctypes.c_void_p),
            ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(ints, ctypes.c_void_p),
            q.data_ptr(), g.data_ptr(), logp.data_ptr(), stds.data_ptr(),
            mean.data_ptr(), logdet.data_ptr(), step0.data_ptr(),
            step_bar.data_ptr(), draws.data_ptr(), stats.data_ptr(),
            q_f.data_ptr(), g_f.data_ptr(), logp_f.data_ptr(),
            iters.data_ptr(), work.data_ptr(), stream)
    _raise_on(rc, lib, "nuts_fused_mid_posterior")
    return draws, stats, q_f, g_f, logp_f, iters


def launch_mid_warmup(seed, flags, q, g, logp, stds, mean, est, sca, model,
                      opts, sset, use_grad_based, B):
    """Launch csrc/nuts_fused_mid_warmup.cu; returns (draws [K, C, d],
    stats [K, C, NSTATS_W], q, g, logp, stds, mean, est, sca, iters).  As
    the ld warmup kernel, it keeps a chain's current q and g and its
    estimator planes in the output buffers, which start as copies of the
    inputs."""
    check_warmup_args(flags, q, g, logp, stds, mean, est, sca)
    (C, d, D, model_id, params, ptrs, ints, work,
     lib) = _mid_common("warmup", q, model, opts, B)
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
        rc = lib.nrt_mid_warmup_launch(
            d, D, C, B, K, int(seed) & 0xFFFFFFFF,
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
    _raise_on(rc, lib, "nuts_fused_mid_warmup")
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
    lib = library()
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
    lib = library()
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
    (C, d, model_id, params, ptrs, ints, consts, fconsts,
     lib) = _mclmc_mid_common(q, model, mopts, B)
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
    return draws, stats, q_f, g_f, logp_f, v_f, iters


def launch_mclmc_mid_warmup(seed, flags, q, g, logp, v, stds, mean, est, sca,
                            model, mopts, sset, use_grad_based, B):
    """Launch csrc/mclmc_fused_mid_warmup.cu; returns (draws [K, C, d],
    stats [K, C, 9], q, g, logp, v, stds, mean, est, sca, iters).  As the ld
    NUTS warmup kernel, it keeps a chain's current q and g and its estimator
    planes in the output buffers, which start as copies of the inputs."""
    check_mclmc_warmup_args(flags, q, g, logp, v, stds, mean, est, sca,
                            mopts)
    (C, d, model_id, params, ptrs, ints, consts, fconsts,
     lib) = _mclmc_mid_common(q, model, mopts, B)
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
            est_f.data_ptr(), sca_f.data_ptr(), iters.data_ptr(), stream)
    _raise_on(rc, lib, "mclmc_fused_mid_warmup")
    return (draws, stats, q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f,
            iters)
