"""Kernels written by hand for NVIDIA Hopper, with their plain versions.

The port of ``deeplearning4j_tpu/ops/pallas_kernels.py``.  Seven kernels:

``fused_conv2d_bias_act`` (``csrc/conv_bias_act.cu``) replaces the Pallas
TPU kernel ``_conv_bias_act_kernel`` (``pallas_kernels.py:577``, launched
by ``_conv_forward`` :605 through ``fused_conv2d_bias_act`` :652): a
stride-1 conv with f32 accumulation, + bias, + one of the 15 elementwise
activations of :data:`CONV_FUSED_ACTS`, applied before the single write
of the output.  It is an implicit GEMM on the tensor cores (``wgmma``),
f32-accurate through three TF32 products per product (3xTF32), fed by a
ring of ``cp.async`` copies; it is bound by operations, and the source
file's header says how the design answers that.  A filter as wide as the
padded input (OW == 1: a text CNN's h x D over word vectors) takes the
kernel's full-width route, a plain GEMM whose A tiles are copied straight
from x, with the same products and epilogue.  Its backward recomputes
through the plain conv and differentiates that, as ``_conv_vjp_bwd``
(:639) does, with TF32 off for those convs.  Its bf16 form, for bf16 x, w
and b (the TPU kernel takes both types), multiplies on the tensor cores in
bf16 with f32 accumulation (``wgmma...f32.bf16.bf16``, one product where
f32 takes three) and stores y once, rounded to bf16; its backward
recomputes from the bf16 inputs upcast to f32 and rounds the gradients to
bf16, as JAX's ``_conv_ref_nhwc`` (:620) does through its f32 conv and the
cast back.

``fused_softmax_xent`` (``csrc/softmax_xent.cu``) replaces
``_softmax_xent_kernel`` (:466, launched by ``fused_softmax_xent`` :500):
per-row softmax cross-entropy loss and its gradient, each row read from
device memory once and held in registers (a warp per row up to 2,048
wide, a thread block cluster beyond; past 131,072 a row's further
elements are streamed and read twice).
``softmax_xent_rows`` is the differentiable loss; its backward scales
the saved gradient, as ``_sxr_bwd`` (:535) does.

``fused_threshold_dropout`` (``csrc/threshold_dropout.cu``) replaces
``_dropout_kernel`` (:827, launched by ``_dropout_forward`` :841):
inverted dropout whose mask is a counter-hash threshold test, so the
backward is the same kernel on the gradient with the same seed words and
no mask is stored.  Kernel and plain version are bit-identical to the
JAX ``threshold_dropout_reference`` (:907).  Its bf16 form keeps the f32
form's masks and scales in f32 before one rounding to bf16, as
``_threshold_dropout_math`` (:811) does.  Both xent and dropout are bound
by bytes.

``fused_lstm_step`` (``csrc/lstm_step.cu``) replaces ``_lstm_step_kernel``
(:703, launched by ``_lstm_forward`` :730 through ``fused_lstm_step``
:754): one peephole-LSTM step, the recurrent product ``h @ RW`` and all
the gate math in one launch.  Its backward differentiates the plain
version (``lstm_step_reference``) from the saved inputs, as
``_lstm_vjp_bwd`` (:764) does.

``flash_forward``, ``flash_dq`` and ``flash_dkv`` (``csrc/flash_attention.cu``)
replace ``_flash_fwd_kernel`` (:128, launched by ``_flash_fwd`` :196),
``_flash_dq_kernel`` (:238) and ``_flash_dkv_kernel`` (:274, both launched
by ``_flash_bwd`` :341/:357): exact attention with an online softmax that
never writes the [T, T] scores, its per-row log-sum-exp, and the two
backward kernels that recompute the probabilities from it.
``flash_attention`` is the differentiable entry point
(``_FlashAttention``, the ``custom_vjp`` of :397-414).  The bf16 forms of
the lstm step and the three flash kernels keep the TPU kernels' f32
arithmetic on bf16 inputs: the lstm step upcasts its five inputs and
rounds c' and h' once; the flash kernels multiply bf16 operands on the
tensor cores (``wgmma...f32.bf16.bf16``, each after a split pre-pass
that writes the streamed tiles as the products read them; exact
products, f32 sums), feed the
f32 intermediates P and dS as a bf16 hi + lo pair (two products into one
f32 sum), keep the softmax, lse and delta in f32 and round out, dq, dk
and dv once.  The JAX wrapper's
padding of D and T to 128 (:419-448) is a TPU lane artifact and is not
copied: the kernels mask the last tile and take any head dim up to 128.
All three are bound by operations.  The f32 forms run on the tensor
cores in 3xTF32 (the forward after its own split pre-pass; the two
backward kernels one ``wgmma`` template), except the backward's dP,
which the CUDA cores sum in the order of a plain f32 matmul (the
source's header says why).

Rules every kernel here keeps:

* the wrapper takes the plain PyTorch version (``*_reference``) only for
  a tensor that lies on the CPU; for any other tensor it launches the
  kernel or raises — there is no fallback;
* the kernel libraries are built from the repo's ``csrc/`` at first use
  by ``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``_build/`` and
  loaded with ``ctypes``; a failed build or launch raises;
  :func:`build_libraries` builds them all at once, one ``nvcc`` each;
* the wrapper that launches a kernel counts its launches in a plain
  integer attribute (``fused_conv2d_bias_act.launches``,
  ``fused_softmax_xent.launches``, ``fused_threshold_dropout.launches``,
  ``fused_lstm_step.launches``, ``flash_forward.launches``,
  ``flash_dq.launches``, ``flash_dkv.launches``), and nowhere else; a bf16
  form has a count of its own (``fused_conv2d_bias_act.bf16.launches``,
  ``fused_threshold_dropout.bf16.launches``,
  ``fused_lstm_step.bf16.launches``, ``flash_forward.bf16.launches``,
  ``flash_dq.bf16.launches``, ``flash_dkv.bf16.launches``), and the f32
  counts hold f32 launches only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import activations as act_ops

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# Elementwise activations the conv kernel fuses, mapped to the kernel's
# activation ids (enum Act in csrc/conv_bias_act.cu).  The same 15 names
# as the JAX package's CONV_FUSED_ACTS.
_CONV_ACT_IDS = {
    "identity": 0, "linear": 0, "relu": 1, "relu6": 2, "tanh": 3,
    "sigmoid": 4, "leakyrelu": 5, "elu": 6, "gelu": 7, "softplus": 8,
    "softsign": 9, "swish": 10, "selu": 11, "hardsigmoid": 12,
    "hardtanh": 13}
CONV_FUSED_ACTS = frozenset(_CONV_ACT_IDS)

# The conv kernel's constants that its gate needs (constexpr in
# csrc/conv_bias_act.cu, which the tests parse): largest KH/KW of the halo
# route, output pixels (rows of M) per tile, K per slice, the split
# weights' row padding.
CONV_MAX_K = 7
_CONV_BM = 128
_CONV_BK = 64
_CONV_W_ROW_PAD = 64
_INT_MAX = 2 ** 31 - 1
_GRID_YZ_MAX = 65535


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    for cand in (shutil.which(name),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels are built from "
                       f"csrc/ at first use and need the CUDA toolkit")


class KernelLibrary:
    """One ``csrc/*.cu`` source built into a shared library with a plain C
    interface and loaded with ctypes, once per process.  The library's
    file name carries a hash of the source and of the local headers it
    includes (``#include "..."``), so an edited source or header is
    rebuilt and a stale build is never loaded."""

    def __init__(self, source: Path, symbols: dict):
        self.source = Path(source)
        self._symbols = symbols       # name -> (argtypes, restype)
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""

    def sources(self) -> list:
        """The source, then every local header it includes, directly or
        through another header, each once."""
        files, i = [self.source], 0
        while i < len(files):
            for name in _LOCAL_INCLUDE.findall(files[i].read_text()):
                header = files[i].parent / name
                if header not in files:
                    files.append(header)
            i += 1
        return files

    def path(self) -> Path:
        digest = hashlib.sha256(b"".join(f.read_bytes()
                                         for f in self.sources())
                                + " ".join(ARCH_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}-{digest[:12]}.so"

    def build(self) -> Path:
        """Compile the source unless this exact build exists.  nvcc's
        output (ptxas's registers, spills and notes) is kept beside the
        library, so ``build_log`` holds it whichever process built it."""
        out = self.path()
        if out.exists():
            log = out.with_suffix(".log")
            if not self.build_log and log.exists():
                self.build_log = log.read_text()
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cuda_tool("nvcc"), *ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o",
               str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(rc {proc.returncode}):\n{self.build_log}")
        log = out.with_suffix(f".{os.getpid()}.log")
        log.write_text(self.build_log)
        os.replace(log, out.with_suffix(".log"))
        os.replace(tmp, out)    # atomic against a concurrent builder
        return out

    def get(self):
        """The loaded library, building it on first use."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, (argtypes, restype) in self._symbols.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                self._lib = lib
            return self._lib


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
CONV_LIBRARY = KernelLibrary(
    CSRC / "conv_bias_act.cu",
    {"dl4j_conv2d_bias_act_f32": ([_P] * 5 + [_I] * 12 + [_P], _I),
     "dl4j_conv2d_bias_act_bf16": ([_P] * 5 + [_I] * 12 + [_P], _I),
     "dl4j_conv2d_bf16_route": ([_I] * 11 + [_P, _P], _I),
     "dl4j_conv2d_plan": ([_I] * 8 + [_P], _I)})
XENT_LIBRARY = KernelLibrary(
    CSRC / "softmax_xent.cu",
    {"dl4j_softmax_xent_f32": ([_P, _P, _P, _P, _I, _I, _P], _I),
     "dl4j_softmax_xent_plan": ([_I, _I, _I, _P], _I),
     "dl4j_launch_floor": ([_I, _I, _P], _I)})
DROPOUT_LIBRARY = KernelLibrary(
    CSRC / "threshold_dropout.cu",
    {"dl4j_threshold_dropout_f32": (
        [_P, _P, _U, _U, _U, _U, ctypes.c_float, _P], _I),
     "dl4j_threshold_dropout_bf16": (
        [_P, _P, _U, _U, _U, _U, ctypes.c_float, _P], _I)})
LSTM_LIBRARY = KernelLibrary(
    CSRC / "lstm_step.cu",
    {"dl4j_lstm_step_f32": ([_P, _I] + [_P] * 6 + [_I, _I, _P], _I),
     "dl4j_lstm_step_bf16": ([_P, _I] + [_P] * 6 + [_I, _I, _P], _I)})
_F = ctypes.c_float
FLASH_LIBRARY = KernelLibrary(
    CSRC / "flash_attention.cu",
    {"dl4j_flash_fwd_f32": ([_P] * 7 + [_I] * 5 + [_F, _P], _I),
     "dl4j_flash_dq_f32": ([_P] * 8 + [_I] * 5 + [_F, _P], _I),
     "dl4j_flash_dkv_f32": ([_P] * 9 + [_I] * 5 + [_F, _P], _I),
     "dl4j_flash_fwd_bf16": ([_P] * 7 + [_I] * 5 + [_F, _P], _I),
     "dl4j_flash_dq_bf16": ([_P] * 9 + [_I] * 5 + [_F, _P], _I),
     "dl4j_flash_dkv_bf16": ([_P] * 10 + [_I] * 5 + [_F, _P], _I)})
LIBRARIES = (CONV_LIBRARY, XENT_LIBRARY, DROPOUT_LIBRARY, LSTM_LIBRARY,
             FLASH_LIBRARY)


def build_libraries() -> None:
    """Build and load every kernel library at once: one ``nvcc`` process
    per source, all started together.  Raises if any build fails."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(KernelLibrary.get, LIBRARIES))


def sass_hgmma_counts(library: KernelLibrary, operand: str = "",
                      instruction: str = "HGMMA") -> dict:
    """HGMMA (wgmma) instructions in each kernel function of ``library``'s
    SASS, counted in ``cuobjdump -sass``'s listing: {mangled name: count};
    with ``operand`` (``"BF16"``, ``"TF32"``) only those whose line names
    it; with ``instruction`` ``"HMMA"`` the warp-level tensor-core products
    (``mma.sync``) instead.  Builds the library."""
    library.get()
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                           str(library.path())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, function = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            function = head.group(1)
            counts[function] = 0
        elif function is not None and instruction in line and \
                operand in line:
            counts[function] += 1
    return counts


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(fn) -> None:
    with _launch_lock:
        fn.launches += 1


_launch_lock = threading.Lock()


class LaunchCount:
    """The launch count of a kernel form that shares its wrapper with
    another (a bf16 form): ``launches``, a plain integer."""

    def __init__(self):
        self.launches = 0


# The dtypes the conv, dropout, lstm and flash kernels take: each has an
# f32 and a bf16 form, as the TPU kernels take both.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _one_dtype(what: str, **tensors) -> None:
    """Raise unless the named tensors share one dtype: a kernel form takes
    one, and the CPU path refuses what the card's would."""
    dtypes = {n: t.dtype for n, t in tensors.items()}
    if len(set(dtypes.values())) > 1:
        raise ValueError(f"{what} takes inputs of one dtype; got " + ", ".join(
            f"{n} {d}" for n, d in dtypes.items()))


# ---------------------------------------------------------------------------
# conv2d + bias + activation
# ---------------------------------------------------------------------------

def conv_pads(KH: int, KW: int, pad: Sequence[int], border_mode: str):
    """((top, bottom), (left, right)) for a stride-1 conv.  'same' splits
    K-1 like XLA's SAME: low = (K-1)//2, the odd row/col goes HIGH."""
    if border_mode == "same":
        return (((KH - 1) // 2, KH - 1 - (KH - 1) // 2),
                ((KW - 1) // 2, KW - 1 - (KW - 1) // 2))
    return ((int(pad[0]), int(pad[0])), (int(pad[1]), int(pad[1])))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# The fields of a plan, in the order dl4j_conv2d_plan writes them.
CONV_PLAN_FIELDS = ("bn", "ni", "th", "tw", "hr", "hp", "nch", "halo_floats",
                    "tiles_n", "tiles_h", "tiles_w", "tiles_c", "slices",
                    "cs", "per_rank", "stage_bytes", "smem", "fw", "blocks")


def conv_plan(N, Cin, KH, KW, Cout, OH, OW, sms: int):
    """The conv library's own tiling of a stride-1 conv on a card with
    ``sms`` SMs (``dl4j_conv2d_plan``), as a dict of
    :data:`CONV_PLAN_FIELDS`, or None where the kernel does not apply.
    Builds the library; the plan is kept in the C source only."""
    out = (ctypes.c_int * len(CONV_PLAN_FIELDS))()
    err = CONV_LIBRARY.get().dl4j_conv2d_plan(N, Cin, KH, KW, Cout, OH, OW,
                                              sms, out)
    return None if err else dict(zip(CONV_PLAN_FIELDS, out))


def conv_split_floats(Cout: int, Cin: int, KH: int, KW: int) -> int:
    """Floats of the scratch that holds the split weights, w_hi and w_lo,
    each [Cout padded to 64][Cin*KH*KW padded to a K slice, 64]."""
    return 2 * conv_reordered_elements(Cout, Cin, KH, KW)


def conv_reordered_elements(Cout: int, Cin: int, KH: int, KW: int) -> int:
    """Elements of the bf16 form's reordered weights, [Cout padded to
    64][Cin*KH*KW padded to a K slice, 64]."""
    return _cdiv(Cout, _CONV_W_ROW_PAD) * _CONV_W_ROW_PAD * \
        _cdiv(Cin * KH * KW, _CONV_BK) * _CONV_BK


# The bf16 form's routes, by the ids dl4j_conv2d_bf16_route returns.
CONV_BF16_ROUTES = {0: "halo", 1: "full_width", 2: "gemm", 3: "gemm"}


def conv_bf16_route(N, Cin, H, W, Cout, KH, KW, pt, pl) -> Optional[str]:
    """The route the conv kernel's bf16 form takes for a shape the gate
    accepts (``gemm_route`` and ``supported`` of csrc/conv_bias_act.cu):
    ``"gemm"`` for a 1x1 conv with no padding, a plain GEMM over pixels;
    ``"halo"`` for every other shape the halo route takes;
    ``"full_width"`` for the rest (OW == 1); None where the kernel does not
    apply.  ``pt`` and ``pl`` are the top and left padding, and the bottom
    and right padding are taken equal to them."""
    OH, OW = H + 2 * pt - KH + 1, W + 2 * pl - KW + 1
    if _conv_halo_supported(N, Cin, KH, KW, Cout, OH, OW):
        if KH == KW == 1 and pt == pl == 0:
            return "gemm"
        return "halo"
    if _conv_full_width_supported(N, Cin, KH, KW, Cout, OH, OW):
        return "full_width"
    return None


def conv_bf16_library_route(x, N, Cin, H, W, Cout, KH, KW, pt, pl, OH, OW):
    """The bf16 form's route as the built library decides it
    (``dl4j_conv2d_bf16_route``), for x's address: (route name, whether
    the GEMM route reads a pre-pass image, scratch elements), or None where
    the kernel does not apply.  Builds the library; the answer depends on
    the address only through its alignment, and is kept per shape."""
    return _conv_bf16_library_route(CONV_LIBRARY, N, Cin, H, W, Cout, KH, KW,
                                    pt, pl, OH, OW, x.data_ptr() % 16)


@functools.lru_cache(maxsize=1024)
def _conv_bf16_library_route(library, N, Cin, H, W, Cout, KH, KW, pt, pl, OH,
                             OW, align):
    scratch = ctypes.c_longlong(0)
    rid = library.get().dl4j_conv2d_bf16_route(
        N, Cin, H, W, Cout, KH, KW, pt, pl, OH, OW, 16 + align,
        ctypes.byref(scratch))
    if rid < 0:
        return None
    return CONV_BF16_ROUTES[rid], rid == 3, scratch.value


def conv_fused_supported(x_shape, w_shape, dtype, stride=(1, 1),
                         dilation=(1, 1), activation: str = "identity",
                         pad=(0, 0), border_mode: str = "truncate") -> bool:
    """Support predicate of the conv kernel: stride 1, dilation 1, f32 or
    bf16 (the two forms), one of :data:`CONV_FUSED_ACTS`, and the
    closed-form limits of ``supported()`` in csrc/conv_bias_act.cu, for
    either route.  The halo
    route: KH and KW at most 7, K = Cin*KH*KW at most 2^30, a halo offset
    from a tile's first image that fits an int, and a grid of at most
    2^31 - 1 blocks.  The full-width route, for a filter as wide as the
    padded input (OW == 1, a text CNN's h x D): KH and KW of any size, K at
    most 2^30, Cin*(OH+KH-1)*KW (which bounds an offset in an image) and
    N*OH within an int, and the grid within 2^31 - 1.  Unlike the TPU gate
    it has no per-image budget: the kernel tiles the output, so VGG16 at
    224x224 (a 226x226x64 padded input) is accepted."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if tuple(stride) != (1, 1) or tuple(dilation) != (1, 1):
        return False
    if (activation or "identity").lower() not in CONV_FUSED_ACTS:
        return False
    if dtype not in KERNEL_DTYPES:
        return False
    N, Cin, H, W = (int(d) for d in x_shape)
    Cout, Cin_w, KH, KW = (int(d) for d in w_shape)
    if Cin_w != Cin:
        return False
    (pt, pb), (pl_, pr) = conv_pads(KH, KW, pad, border_mode)
    OH, OW = H + pt + pb - KH + 1, W + pl_ + pr - KW + 1
    return (_conv_halo_supported(N, Cin, KH, KW, Cout, OH, OW)
            or _conv_full_width_supported(N, Cin, KH, KW, Cout, OH, OW))


def _conv_halo_supported(N, Cin, KH, KW, Cout, OH, OW) -> bool:
    """``halo_supported()`` of csrc/conv_bias_act.cu."""
    if min(N, Cin, Cout, OH, OW, KH, KW) < 1 or max(KH, KW) > CONV_MAX_K:
        return False
    if Cin * KH * KW > 2 ** 30:
        return False
    # a tile holds several images only when one image fits in a tile
    ni = min(N, _CONV_BM // (OH * OW)) if OH * OW <= _CONV_BM else 1
    if ni * Cin * (OH + KH - 1) * (OW + KW - 1) > _INT_MAX:
        return False
    # every tile has an output pixel; a K split only multiplies grids
    # below two blocks per SM
    return N * OH * OW * _cdiv(Cout, 32 if Cout <= 32 else 64) <= _INT_MAX


def _conv_full_width_supported(N, Cin, KH, KW, Cout, OH, OW) -> bool:
    """``full_width_supported()`` of csrc/conv_bias_act.cu: OW == 1."""
    if min(N, Cin, Cout, OH, KH, KW) < 1 or OW != 1:
        return False
    if Cin * KH * KW > 2 ** 30 or Cin * (OH + KH - 1) * KW > _INT_MAX:
        return False
    return N * OH <= _INT_MAX and \
        _cdiv(N * OH, _CONV_BM) * _cdiv(Cout, 32 if Cout <= 32 else 64) \
        <= _INT_MAX


def conv2d_bias_act_reference(x, w, b, pad=(0, 0),
                              border_mode: str = "truncate",
                              activation: str = "identity"):
    """The plain PyTorch version: ``F.conv2d`` on the padded input, +
    bias, + activation.  The CPU path of the wrapper, and the yardstick
    of correctness for the kernel on the card.  bf16 x, w and b are
    upcast to f32, the whole function runs in f32 and the result is
    rounded once to bf16, the semantics of the TPU kernel's bf16 form
    (:577-597); under autograd the gradients come back in bf16."""
    if x.dtype == torch.bfloat16:
        return conv2d_bias_act_reference(
            x.float(), w.float(), b.float(), pad, border_mode,
            activation).to(torch.bfloat16)
    KH, KW = w.shape[2], w.shape[3]
    (pt, pb), (pl_, pr) = conv_pads(KH, KW, pad, border_mode)
    y = F.conv2d(F.pad(x, (pl_, pr, pt, pb)), w)
    y = y + b.reshape(1, -1, 1, 1)
    return act_ops.get(activation or "identity")(y)


@contextlib.contextmanager
def full_f32_convs():
    """cuDNN convs in full f32 for the duration, TF32 off (PyTorch lets
    cuDNN use TF32 for f32 convs by default); the previous setting is
    restored on exit.  The conv backward runs under it, so its gradients
    are f32 like the reference's."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _launch_conv(x, w, b, pad, border_mode, act):
    """One launch of the conv kernel on CUDA tensors x, w, b: the f32 form
    for float32, the bf16 form for bfloat16."""
    if not (x.is_cuda and w.is_cuda and b.is_cuda):
        raise ValueError(f"conv kernel needs CUDA tensors, got x on "
                         f"{x.device}, w on {w.device}, b on {b.device}")
    if not (w.device == x.device == b.device):
        raise ValueError("x, w and b must be on one device")
    if x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype or \
            b.dtype != x.dtype:
        raise ValueError(f"conv kernel takes x, w and b of one dtype, "
                         f"float32 or bfloat16; got x {x.dtype}, w "
                         f"{w.dtype}, b {b.dtype}")
    if b.shape != (w.shape[0],):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({w.shape[0]},)")
    lib = CONV_LIBRARY.get()
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    N, Cin, H, W = x.shape
    Cout, _, KH, KW = w.shape
    (pt, pb), (pl_, pr) = conv_pads(KH, KW, pad, border_mode)
    OH, OW = H + pt + pb - KH + 1, W + pl_ + pr - KW + 1
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty((N, Cout, OH, OW), dtype=x.dtype, device=x.device)
    if bf16:
        # the reordered weights and, on the GEMM route for a plane that
        # 8- and 16-byte copies cannot read, the pre-pass image
        route = conv_bf16_library_route(x, N, Cin, H, W, Cout, KH, KW, pt,
                                        pl_, OH, OW)
        ws = torch.empty((route[2] if route else 0,),
                         dtype=torch.bfloat16, device=x.device)
        launch = lib.dl4j_conv2d_bias_act_bf16
    else:
        ws = torch.empty((conv_split_floats(Cout, Cin, KH, KW),),
                         dtype=torch.float32, device=x.device)
        launch = lib.dl4j_conv2d_bias_act_f32
    # the library plans and launches on the current device: switch to x's
    # only when it is another (a small share of a small conv's host time)
    with (contextlib.nullcontext()
          if x.device.index == torch.cuda.current_device()
          else torch.cuda.device(x.device)):
        err = launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            ws.data_ptr(), N, Cin, H, W, Cout, KH, KW, pt, pl_, OH, OW,
            _CONV_ACT_IDS[act], _stream(x))
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed: CUDA error {err} "
                           f"for x{tuple(x.shape)} w{tuple(w.shape)} "
                           f"{x.dtype}")
    _count(fused_conv2d_bias_act.bf16 if bf16 else fused_conv2d_bias_act)
    return y


class _ConvBiasAct(torch.autograd.Function):
    """Forward: the kernel.  Backward: recompute through the plain
    conv + bias + activation and differentiate that — one extra conv
    buys gradients that are exactly the dense path's, as the JAX
    package's ``_conv_vjp_bwd`` does (it has no Pallas backward either).
    Those convs run in full f32 (:func:`full_f32_convs`); for the bf16
    form they run on the bf16 inputs upcast to f32, and the gradients come
    back rounded to bf16, the dtypes of the inputs.  ``backwards`` counts
    the backward calls (a frozen conv, whose inputs take no gradient,
    makes none)."""

    backwards = 0

    @staticmethod
    def forward(ctx, x, w, b, pad, border_mode, act):
        ctx.save_for_backward(x, w, b)
        ctx.conf = (pad, border_mode, act)
        return _launch_conv(x, w, b, pad, border_mode, act)

    @staticmethod
    def backward(ctx, g):
        _ConvBiasAct.backwards += 1
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad(), full_f32_convs():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            y = conv2d_bias_act_reference(*leaves, *ctx.conf)
            grads = iter(torch.autograd.grad(
                y, [t for t in leaves if t.requires_grad], g))
        return tuple(next(grads) if n else None for n in need) + \
            (None, None, None)


def fused_conv2d_bias_act(x, w, b, stride=(1, 1), pad=(0, 0),
                          dilation=(1, 1), border_mode: str = "truncate",
                          activation: str = "identity"):
    """Fused conv + bias + activation, NCHW in / OIHW weights, for shapes
    :func:`conv_fused_supported` accepts.  A CPU tensor takes the plain
    version; any other tensor launches the CUDA kernel or raises.  When
    autograd records, the output has a backward (:class:`_ConvBiasAct`);
    under ``no_grad``/``inference_mode`` the Function runs forward only."""
    act = (activation or "identity").lower()
    if not conv_fused_supported(x.shape, w.shape, x.dtype, stride, dilation,
                                act, pad, border_mode):
        raise ValueError(
            f"conv kernel does not take x{tuple(x.shape)} w{tuple(w.shape)} "
            f"{x.dtype} stride={tuple(stride)} dilation={tuple(dilation)} "
            f"activation={act!r}")
    if x.device.type == "cpu":
        return conv2d_bias_act_reference(x, w, b, pad, border_mode, act)
    pad = tuple(int(p) for p in pad)
    return _ConvBiasAct.apply(x, w, b, pad, border_mode, act)


fused_conv2d_bias_act.launches = 0
fused_conv2d_bias_act.bf16 = LaunchCount()


# ---------------------------------------------------------------------------
# softmax cross-entropy, loss and gradient
# ---------------------------------------------------------------------------

# The widest row the xent kernel holds in registers: a cluster of 8 blocks
# of 512 threads, 32 floats of x and y each (kMaxCluster, kBlockThreads,
# kBlockPer in csrc/softmax_xent.cu, which the tests parse).  Wider rows
# stream their further elements and read them twice.
XENT_REGISTER_ROW = 8 * 512 * 32


def softmax_xent_supported(shape, dtype) -> bool:
    """Support predicate of the xent kernel: 2-D f32 [N, V] with V below
    2^31 and N rows, times the up to 8 blocks a row takes, within CUDA's
    grid."""
    if len(shape) != 2 or dtype != torch.float32:
        return False
    N, V = (int(d) for d in shape)
    return 1 <= N and 8 * N < 2 ** 31 and 1 <= V < 2 ** 31


def softmax_xent_reference(logits, labels):
    """The plain version: (per-row loss [N], dlogits [N, V]) with the
    kernel's math, ``loss = -sum y ((x - m) - log z)`` and
    ``grad = softmax(x) * sum y - y``."""
    m = logits.amax(dim=1, keepdim=True)
    e = torch.exp(logits - m)
    z = e.sum(dim=1, keepdim=True)
    logp = (logits - m) - torch.log(z)
    loss = -(labels * logp).sum(dim=1)
    grad = e / z * labels.sum(dim=1, keepdim=True) - labels
    return loss, grad


def xent_plan(n_rows: int, V: int, aligned: bool = True) -> dict:
    """The xent kernel's launch plan on the current CUDA device, as the
    built library makes it (the plan lives in the C source): floats per
    load (4 where V % 4 == 0 and the rows are 16-byte aligned), floats of
    x and of y per thread, threads per block, blocks per row (a thread
    block cluster when above 1)."""
    out = (ctypes.c_int * 4)()
    err = XENT_LIBRARY.get().dl4j_softmax_xent_plan(
        int(n_rows), int(V), int(bool(aligned)), out)
    if err != 0:
        raise ValueError(f"xent kernel does not take [{n_rows}, {V}]")
    return dict(zip(("vec", "per_thread", "threads", "blocks_per_row"), out))


def fused_softmax_xent(logits, labels):
    """(per-row loss [N], dlogits [N, V]) in one fused pass.  A CPU tensor
    takes the plain version; any other tensor launches the kernel or
    raises."""
    if not softmax_xent_supported(logits.shape, logits.dtype) or \
            labels.shape != logits.shape or labels.dtype != logits.dtype:
        raise ValueError(f"xent kernel does not take logits "
                         f"{tuple(logits.shape)} {logits.dtype}, labels "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if logits.device.type == "cpu":
        return softmax_xent_reference(logits, labels)
    if not (logits.is_cuda and labels.device == logits.device):
        raise ValueError(f"xent kernel needs CUDA tensors on one device, "
                         f"got logits on {logits.device}, labels on "
                         f"{labels.device}")
    lib = XENT_LIBRARY.get()
    x, y = logits.detach().contiguous(), labels.detach().contiguous()
    N, V = x.shape
    loss = torch.empty((N,), dtype=torch.float32, device=x.device)
    grad = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.dl4j_softmax_xent_f32(
            x.data_ptr(), y.data_ptr(), loss.data_ptr(), grad.data_ptr(),
            N, V, _stream(x))
    if err != 0:
        raise RuntimeError(f"xent kernel launch failed: CUDA error {err} "
                           f"for logits {tuple(x.shape)}")
    _count(fused_softmax_xent)
    return loss, grad


fused_softmax_xent.launches = 0


class _SoftmaxXentRows(torch.autograd.Function):
    """Per-row loss whose backward reuses the gradient the forward pass
    already produced (``_sxr_fwd`` / ``_sxr_bwd``, :526-538)."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, grad = fused_softmax_xent(logits, labels)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        grad, = ctx.saved_tensors
        return grad * g[:, None], None


def softmax_xent_rows(logits, labels):
    """Differentiable fused softmax + cross-entropy: per-row loss [N] of
    logits [N, V] against labels [N, V] (labels get no gradient)."""
    return _SoftmaxXentRows.apply(logits, labels)


# ---------------------------------------------------------------------------
# threshold dropout
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
DROPOUT_MIN_ELEMENTS = 1 << 12


def dropout_fused_supported(shape, dtype) -> bool:
    """Support predicate of the dropout tier, the JAX gate (:919): f32 or
    bf16, at least 4,096 elements, so that skipping the mask tensor beats
    the launch; fewer than 2^32, the range of the kernel's uint32 element
    ids."""
    if dtype not in KERNEL_DTYPES:
        return False
    n = 1
    for d in shape:
        n *= int(d)
    return DROPOUT_MIN_ELEMENTS <= n < 2 ** 32


def dropout_seed_words(seed) -> Tuple[int, int]:
    """The two uint32 seed words of a dropout call, from any pair of
    integers (a tuple, or a tensor or array of two)."""
    s0, s1 = (int(v) & _M32 for v in (seed.tolist()
                                      if hasattr(seed, "tolist") else seed))
    return s0, s1


def dropout_threshold(rate: float) -> int:
    """round(rate * 2^24) with Python's round (half to even), as the JAX
    kernel computes it: an element is kept iff (hash >> 8) < this."""
    return int(round(float(rate) * float(1 << 24)))


def dropout_scale(rate: float) -> float:
    """float32(1 / rate), computed in double and rounded once.  Kept
    elements are multiplied by it; dividing by ``rate`` would round
    differently."""
    return ctypes.c_float(1.0 / float(rate)).value


def _mul32(a, c: int):
    """(a * c) mod 2^32 for an int64 tensor a < 2^32, without int64
    overflow: c is split into 16-bit halves."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(idx, s0: int, s1: int):
    """The kernel's xxhash-style avalanche (``_mix32``, :797) on an int64
    tensor of uint32 element ids; returns uint32 values as int64."""
    h = _mul32(idx, 2654435761) ^ s0
    h = _mul32(h, 2246822519)
    h = h ^ (h >> 13)
    h = _mul32(h ^ s1, 3266489917)
    return h ^ (h >> 16)


def threshold_dropout_reference(x, rate: float, seed):
    """The plain version: the kernel's mask and scaling from the C-order
    element ids of x, bit-identical to the kernel.  A bf16 x is scaled in
    f32 and rounded once to bf16, with the f32 form's mask."""
    if rate >= 1.0 or rate <= 0.0:
        return x
    s0, s1 = dropout_seed_words(seed)
    idx = torch.arange(x.numel(), dtype=torch.int64,
                       device=x.device).reshape(x.shape)
    keep = (mix32(idx, s0, s1) >> 8) < dropout_threshold(rate)
    if x.dtype == torch.bfloat16:
        return torch.where(keep, x.float() * dropout_scale(rate),
                           0.0).to(torch.bfloat16)
    # a float32 tensor times a Python float multiplies in float32, and the
    # scale is a float32 value: the same one rounding as the kernel's
    return torch.where(keep, x * dropout_scale(rate), 0.0)


def _threshold_dropout(x, rate: float, seed):
    """One application, forward or backward: the plain version for a CPU
    tensor, one kernel launch for any other."""
    if x.device.type == "cpu":
        return threshold_dropout_reference(x, rate, seed)
    if not x.is_cuda or x.dtype not in KERNEL_DTYPES or \
            x.numel() >= 2 ** 32:
        raise ValueError(f"dropout kernel takes a CUDA float32 or bfloat16 "
                         f"tensor of fewer than 2^32 elements, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    bf16 = x.dtype == torch.bfloat16
    lib = DROPOUT_LIBRARY.get()
    x = x.detach().contiguous()
    if x.data_ptr() % 16:
        x = x.clone()            # the kernel moves 16 bytes per access
    y = torch.empty_like(x)
    s0, s1 = dropout_seed_words(seed)
    launch = (lib.dl4j_threshold_dropout_bf16 if bf16
              else lib.dl4j_threshold_dropout_f32)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), y.data_ptr(), x.numel(), s0, s1,
            dropout_threshold(rate), dropout_scale(rate), _stream(x))
    if err != 0:
        raise RuntimeError(f"dropout kernel launch failed: CUDA error {err} "
                           f"for x{tuple(x.shape)} {x.dtype}")
    _count(fused_threshold_dropout.bf16 if bf16 else fused_threshold_dropout)
    return y


class _ThresholdDropout(torch.autograd.Function):
    """The residual is the seed alone: the backward applies the same
    masked scaling to the gradient (``_dropout_vjp_bwd``, :864)."""

    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return _threshold_dropout(x, rate, seed)

    @staticmethod
    def backward(ctx, g):
        return _threshold_dropout(g, ctx.rate, ctx.seed), None, None


def fused_threshold_dropout(x, rate: float, seed):
    """Inverted dropout with the mask's threshold test inside the kernel.
    ``rate`` is the RETAIN probability; ``seed`` the two uint32 seed words.
    Differentiable; a CPU tensor takes the plain version both ways."""
    if rate >= 1.0 or rate <= 0.0:
        return x
    return _ThresholdDropout.apply(x, float(rate), dropout_seed_words(seed))


fused_threshold_dropout.launches = 0
fused_threshold_dropout.bf16 = LaunchCount()


# ---------------------------------------------------------------------------
# peephole LSTM step
# ---------------------------------------------------------------------------

_LSTM_ROWS_PER_BLOCK = 16    # kNB in csrc/lstm_step.cu


def lstm_fused_supported(n: int, h: int, dtype) -> bool:
    """Support predicate of the lstm kernel: the JAX shape rule (h >= 8,
    h % 8 == 0), f32 or bf16 (the TPU kernel takes both, and the JAX
    selection passes ``x.dtype``), and at most 65,535 blocks of 16 rows.
    The kernel tiles the recurrent product over k, so the TPU's VMEM budget
    has no counterpart and H is otherwise unbounded."""
    if dtype not in KERNEL_DTYPES or h < 8 or h % 8:
        return False
    return 1 <= n <= _LSTM_ROWS_PER_BLOCK * _GRID_YZ_MAX


def lstm_step_formula(zx, h, c, rw, p3):
    """``_lstm_step_reference`` (:738): zx [N, 4H], h, c [N, H], rw [H, 4H],
    p3 [3, H] (pI, pF, pO) -> (c', h'), gate layout [i, f, o, c], every op
    in the inputs' dtype.  The function the step's backward differentiates,
    as ``_lstm_vjp_bwd`` (:764) differentiates it: in f32 it is the plain
    version itself; in bf16 each op rounds to bf16, where the kernel (and
    :func:`lstm_step_reference`) keeps the whole step in f32 and rounds c'
    and h' once, so the two differ in bf16 by those roundings."""
    z = zx + h @ rw
    zi, zf, zo, zc = z.chunk(4, dim=-1)
    i = torch.sigmoid(zi + c * p3[0])
    f = torch.sigmoid(zf + c * p3[1])
    g = torch.tanh(zc)
    c_new = f * c + i * g
    o = torch.sigmoid(zo + c_new * p3[2])
    return c_new, o * torch.tanh(c_new)


def lstm_step_reference(zx, h, c, rw, p3):
    """The plain version of the kernel (``_lstm_step_kernel``, :703-725):
    every input upcast to f32, z = zx + h RW and the gate math in f32, h'
    from the unrounded c', then c' and h' rounded once to c's and h's
    dtypes.  The CPU path of the wrapper and the kernel's yardstick on the
    card.  In f32 it is :func:`lstm_step_formula` op for op (``float()``
    and ``to()`` return an f32 tensor itself)."""
    c_new, h_new = lstm_step_formula(*(t.float() for t in (zx, h, c, rw,
                                                           p3)))
    return c_new.to(c.dtype), h_new.to(h.dtype)


@contextlib.contextmanager
def full_f32_matmuls():
    """cuBLAS float32 products in full f32 for the duration (TF32 off);
    the previous setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _launch_lstm_step(zx, h, c, rw, p3):
    """One launch of the lstm kernel on CUDA tensors of one dtype: the f32
    form for float32, the bf16 form for bfloat16; zx may be a row-strided
    view (one time step of [N, T, 4H]), its row stride in elements."""
    N, H = c.shape
    ok = (zx.shape == (N, 4 * H) and h.shape == (N, H)
          and rw.shape == (H, 4 * H) and p3.shape == (3, H)
          and c.dtype in KERNEL_DTYPES
          and all(t.is_cuda and t.device == c.device and t.dtype == c.dtype
                  for t in (zx, h, c, rw, p3)))
    if not ok:
        raise ValueError(
            f"lstm kernel takes CUDA tensors of one dtype, float32 or "
            f"bfloat16, on one device, zx [N, 4H], h, c [N, H], rw [H, 4H], "
            f"p3 [3, H]; got zx {tuple(zx.shape)} {zx.dtype} on {zx.device}, "
            f"h {tuple(h.shape)} {h.dtype}, c {tuple(c.shape)} {c.dtype} on "
            f"{c.device}, rw {tuple(rw.shape)} {rw.dtype}, p3 "
            f"{tuple(p3.shape)} {p3.dtype}")
    lib = LSTM_LIBRARY.get()
    if zx.stride(1) != 1:
        zx = zx.contiguous()
    ld = zx.stride(0) if N > 1 else 4 * H
    h, c, rw, p3 = (t.contiguous() for t in (h, c, rw, p3))
    bf16 = c.dtype == torch.bfloat16
    c_new = torch.empty((N, H), dtype=c.dtype, device=c.device)
    h_new = torch.empty_like(c_new)
    launch = lib.dl4j_lstm_step_bf16 if bf16 else lib.dl4j_lstm_step_f32
    with torch.cuda.device(c.device):
        err = launch(
            zx.data_ptr(), ld, h.data_ptr(), c.data_ptr(), rw.data_ptr(),
            p3.data_ptr(), c_new.data_ptr(), h_new.data_ptr(), N, H,
            _stream(c))
    if err != 0:
        raise RuntimeError(f"lstm kernel launch failed: CUDA error {err} "
                           f"for N={N} H={H} {c.dtype}")
    _count(fused_lstm_step.bf16 if bf16 else fused_lstm_step)
    return c_new, h_new


class _LSTMStep(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, its plain version on CPU
    tensors.  Backward: differentiate :func:`lstm_step_formula` from the
    saved inputs, in their dtype (``_lstm_vjp_bwd``, :764), with TF32 off
    for its product.  Only the step's inputs are saved, not its [N, 4H]
    gates, so a sequence of T steps keeps T small residuals."""

    @staticmethod
    def forward(ctx, zx, h, c, rw, p3):
        ctx.save_for_backward(zx, h, c, rw, p3)
        if c.device.type in ("cpu", "meta"):
            # meta: shapes only (``rnn_carry_template``), nothing runs
            return lstm_step_reference(zx, h, c, rw, p3)
        return _launch_lstm_step(zx, h, c, rw, p3)

    @staticmethod
    def backward(ctx, g_c, g_h):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad(), full_f32_matmuls():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            outs, grads_out = [], []
            for y, g in zip(lstm_step_formula(*leaves), (g_c, g_h)):
                if g is not None:
                    outs.append(y)
                    grads_out.append(g)
            grads = iter(torch.autograd.grad(
                outs, [t for t in leaves if t.requires_grad], grads_out))
        return tuple(next(grads) if n else None for n in need)


def fused_lstm_step(zx, h, c, rw, p3):
    """One peephole-LSTM step -> (c', h') in the inputs' dtype, f32 or bf16,
    for shapes :func:`lstm_fused_supported` accepts.  A CPU tensor takes the
    plain version (a ``meta`` tensor too, which computes nothing); any
    other tensor launches the kernel or raises.
    Differentiable in all five inputs."""
    N, H = c.shape
    if not lstm_fused_supported(N, H, c.dtype):
        raise ValueError(f"lstm kernel does not take N={N} H={H} {c.dtype}")
    _one_dtype("lstm kernel", zx=zx, h=h, c=c, rw=rw, p3=p3)
    return _LSTMStep.apply(zx, h, c, rw, p3)


fused_lstm_step.launches = 0
fused_lstm_step.bf16 = LaunchCount()


# ---------------------------------------------------------------------------
# flash attention: forward, dQ, dK/dV
# ---------------------------------------------------------------------------

NEG_INF = -1e30              # lse of a query row with no live key
FLASH_MIN_T, FLASH_MIN_D = 128, 32   # the JAX gate (:451)
FLASH_MAX_D = 128            # the kernels' shared-memory plan


def flash_attention_supported(q_shape, dtype, kv_len=None) -> bool:
    """Support predicate of the flash kernels: the JAX gate (T >= 128, head
    dim >= 32, keys as long as the queries; no dtype gate, :451-459) and
    the kernels' own limits (f32 or bf16, head dim a multiple of 4 up to
    128, B * H within CUDA's grid).  Any T above the gate works: the
    kernels mask the last tile."""
    if len(q_shape) != 4 or dtype not in KERNEL_DTYPES:
        return False
    B, H, T, D = (int(d) for d in q_shape)
    if kv_len is not None and int(kv_len) != T:
        return False
    return (T >= FLASH_MIN_T and FLASH_MIN_D <= D <= FLASH_MAX_D
            and D % 4 == 0 and 1 <= B * H <= _GRID_YZ_MAX)


def _flash_live(key_mask, T: int, causal: bool):
    """[B, 1, T|1, T] bool: which (query, key) pairs attend."""
    live = (key_mask > 0)[:, None, None, :]
    if causal:
        live = live & torch.ones((T, T), dtype=torch.bool,
                                 device=key_mask.device).tril()
    return live


def flash_forward_reference(q, k, v, key_mask, causal: bool, scale: float):
    """The plain version of the forward kernel -> (out [B, H, T, D], lse
    [B, H, T]), materialising the [T, T] scores.  A query row with no live
    key gets out = 0 and lse = -1e30.  bf16 q, k, v are upcast and the
    whole function runs in f32, out rounded once to q's dtype and lse f32,
    as ``_flash_fwd_kernel`` (:133-177) computes them."""
    dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~_flash_live(key_mask, q.shape[2], causal),
                      float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    row_live = m > float("-inf")
    p = torch.exp(s - torch.where(row_live, m, torch.zeros_like(m)))
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ v) / torch.where(row_live, l, torch.ones_like(l))
    lse = torch.where(row_live, m + torch.log(l), torch.full_like(m, NEG_INF))
    return out.to(dtype), lse.squeeze(-1)


def _flash_probs(q, k, key_mask, lse, causal: bool, scale: float):
    """p recomputed from lse, the exponent clamped to -inf on dead pairs
    and dead rows (``_recompute_p``, :219): exactly 0 there, never inf."""
    s = (q @ k.transpose(-1, -2)) * scale
    live = _flash_live(key_mask, q.shape[2], causal) & \
        (lse > NEG_INF * 0.5)[..., None]
    return torch.exp(torch.where(live, s - lse[..., None], float("-inf")))


def flash_dq_reference(q, k, v, key_mask, dout, lse, delta, causal: bool,
                       scale: float):
    """The plain version of the dQ kernel: scale * (p * (dO V^T - delta)) K,
    bf16 inputs upcast, dq rounded once to q's dtype (:238-271)."""
    dtype = q.dtype
    q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
    p = _flash_probs(q, k, key_mask, lse, causal, scale)
    ds = p * (dout @ v.transpose(-1, -2) - delta[..., None])
    return ((ds @ k) * scale).to(dtype)


def flash_dkv_reference(q, k, v, key_mask, dout, lse, delta, causal: bool,
                        scale: float):
    """The plain version of the dK/dV kernel -> (dk, dv):
    dk = scale * (p * (dO V^T - delta))^T Q, dv = p^T dO, bf16 inputs
    upcast, dk and dv rounded once to k's and v's dtypes (:274-318)."""
    kt, vt = k.dtype, v.dtype
    q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
    p = _flash_probs(q, k, key_mask, lse, causal, scale)
    ds = p * (dout @ v.transpose(-1, -2) - delta[..., None])
    return (((ds.transpose(-1, -2) @ q) * scale).to(kt),
            (p.transpose(-1, -2) @ dout).to(vt))


# The flash inputs that take q's dtype; the key mask, lse and delta are f32
# in both forms, as the TPU kernels take them.
_FLASH_IN_Q_DTYPE = ("k", "v", "dout")


def _flash_args(q, **named):
    """Check a flash kernel's CUDA inputs — q, k, v, dout [B, H, T, D] of
    one dtype, float32 or bfloat16; key_mask [B, T], lse, delta [B, H, T]
    float32; all on q's device — and return them contiguous and 16-byte
    aligned, q first.  A mix of dtypes raises: the kernels read raw
    pointers, so a bf16 tensor reaching an f32 form would be read as other
    numbers."""
    B, H, T, D = q.shape
    shapes = {"k": (B, H, T, D), "v": (B, H, T, D), "dout": (B, H, T, D),
              "key_mask": (B, T), "lse": (B, H, T), "delta": (B, H, T)}
    ok = q.is_cuda and flash_attention_supported(q.shape, q.dtype) and all(
        tuple(t.shape) == shapes[n] and t.device == q.device
        and t.dtype == (q.dtype if n in _FLASH_IN_Q_DTYPE else torch.float32)
        for n, t in named.items())
    if not ok:
        raise ValueError(
            f"flash kernels take CUDA tensors on one device: q, k, v, dout "
            f"[B, H, T, D] of one dtype, float32 or bfloat16, with T >= "
            f"{FLASH_MIN_T} and D in [{FLASH_MIN_D}, {FLASH_MAX_D}], "
            f"D % 4 == 0; key_mask [B, T], lse, delta [B, H, T] float32; got "
            f"q {tuple(q.shape)} {q.dtype} on {q.device}, " + ", ".join(
                f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
                for n, t in named.items()))
    out = [t.contiguous() for t in (q, *named.values())]
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in out]


def _launch_flash(wrapper, kind: str, inputs, outputs, causal: bool,
                  scale: float):
    """Launch the flash kernel ``dl4j_flash_<kind>_<f32|bf16>`` on the
    checked CUDA ``inputs`` (q first, as :func:`_flash_args` returns them)
    into ``outputs``: the form is q's dtype, chosen here and nowhere else.
    The launch is counted on ``wrapper`` (f32) or ``wrapper.bf16``."""
    q = inputs[0]
    B, H, T, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    kernel = getattr(FLASH_LIBRARY.get(),
                     f"dl4j_flash_{kind}_{'bf16' if bf16 else 'f32'}")
    with torch.cuda.device(q.device):
        err = kernel(*(t.data_ptr() for t in (*inputs, *outputs)), B * H, H,
                     T, D, int(causal), float(scale), _stream(q))
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {err} for q{tuple(q.shape)} {q.dtype}")
    _count(wrapper.bf16 if bf16 else wrapper)
    return outputs


def flash_bf16_plan(D: int) -> dict:
    """The bf16 kernels' plans for head dim D (``FwdB16<DP>``, ``DqB16<DP>``,
    ``DkvB16<DP>`` in ``csrc/flash_attention.cu``): ``dp`` the padded head
    dim; ``fwd_tile`` the keys of a forward tile (the pre-pass's and a bulk
    copy's unit), ``fwd_step`` the keys of a step (P V is summed a step at
    a time); ``dq_tile`` and ``dq_step`` the same for dQ (dQ += dS K is
    summed a step at a time); ``dkv_tile`` and ``dkv_step`` the same in
    queries for dK/dV (dK and dV are summed a step at a time)."""
    wide = D > 64
    return {"dp": 128 if wide else 64, "fwd_tile": 64 if wide else 128,
            "fwd_step": 64, "dq_tile": 64, "dq_step": 64, "dkv_tile": 64,
            "dkv_step": 32}


def flash_fwd_scratch_bytes(bh: int, T: int, D: int,
                            dtype=torch.float32) -> int:
    """Bytes of the forward's split pre-pass scratch: ceil(T / KT) tiles
    per head.  f32 (``Fwd<DPAD>``): K and V^T split into tf32 hi and lo
    images (4 x KT x DPAD f32) and KT key biases, KT = 64 keys at D <= 64
    (DPAD 64), else 32 (DPAD 128).  bf16 (``FwdB16<DP>``): K and V^T bf16
    images (2 x KT x DP bf16), KT key biases and a 16-byte flag, KT
    :func:`flash_bf16_plan`'s ``fwd_tile``."""
    if dtype == torch.bfloat16:
        plan = flash_bf16_plan(D)
        dp, kt = plan["dp"], plan["fwd_tile"]
        return bh * _cdiv(T, kt) * (2 * kt * dp * 2 + kt * 4 + 16)
    dpad, kt = (64, 64) if D <= 64 else (128, 32)
    return bh * _cdiv(T, kt) * (4 * kt * dpad * 4 + kt * 4)


def flash_dq_scratch_bytes(bh: int, T: int, D: int) -> int:
    """Bytes of the bf16 dQ kernel's split pre-pass scratch (``DqB16<DP>``):
    ceil(T / KT) key tiles per head of K, V and K^T bf16 images (3 x KT x
    DP bf16), KT key biases and a 16-byte flag, KT
    :func:`flash_bf16_plan`'s ``dq_tile``."""
    plan = flash_bf16_plan(D)
    dp, kt = plan["dp"], plan["dq_tile"]
    return bh * _cdiv(T, kt) * (3 * kt * dp * 2 + kt * 4 + 16)


def flash_dkv_scratch_bytes(bh: int, T: int, D: int) -> int:
    """Bytes of the bf16 dK/dV kernel's split pre-pass scratch
    (``DkvB16<DP>``): ceil(T / QT) query tiles per head of Q, dO, Q^T and
    dO^T bf16 images (4 x QT x DP bf16), lse and delta (2 x QT f32), QT
    :func:`flash_bf16_plan`'s ``dkv_tile``."""
    plan = flash_bf16_plan(D)
    dp, qt = plan["dp"], plan["dkv_tile"]
    return bh * _cdiv(T, qt) * (4 * qt * dp * 2 + 2 * qt * 4)


def flash_forward(q, k, v, key_mask, causal: bool, scale: float):
    """(out, lse) of one attention core, q, k, v [B, H, T, D] f32 or bf16
    (out in q's dtype, lse f32), key_mask [B, T] (> 0 keeps the key).  A CPU
    tensor takes the plain version; any other launches the forward kernel
    of q's dtype after its split pre-pass (into a scratch the wrapper
    allocates and frees) or raises."""
    _one_dtype("flash_forward", q=q, k=k, v=v)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, key_mask, causal, scale)
    inputs = _flash_args(q, k=k, v=v, key_mask=key_mask)
    B, H, T, D = q.shape
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    outputs = (torch.empty_like(inputs[0]), lse,
               torch.empty(flash_fwd_scratch_bytes(B * H, T, D, q.dtype),
                           dtype=torch.uint8, device=q.device))
    return _launch_flash(flash_forward, "fwd", inputs, outputs, causal,
                         scale)[:2]


flash_forward.launches = 0
flash_forward.bf16 = LaunchCount()


def flash_dq(q, k, v, key_mask, dout, lse, delta, causal: bool,
             scale: float):
    """dQ (q's dtype) of one attention core from the forward's lse and
    delta = sum(dout * out, -1), both f32.  A CPU tensor takes the plain
    version; any other launches the dQ kernel of q's dtype (the bf16 form
    after its split pre-pass, into a scratch the wrapper allocates and
    frees) or raises."""
    _one_dtype("flash_dq", q=q, k=k, v=v, dout=dout)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, key_mask, dout, lse, delta, causal,
                                  scale)
    inputs = _flash_args(q, k=k, v=v, key_mask=key_mask, dout=dout, lse=lse,
                         delta=delta)
    outputs = (torch.empty_like(inputs[0]),)
    if q.dtype == torch.bfloat16:
        B, H, T, D = q.shape
        outputs += (torch.empty(flash_dq_scratch_bytes(B * H, T, D),
                                dtype=torch.uint8, device=q.device),)
    return _launch_flash(flash_dq, "dq", inputs, outputs, causal, scale)[0]


flash_dq.launches = 0
flash_dq.bf16 = LaunchCount()


def flash_dkv(q, k, v, key_mask, dout, lse, delta, causal: bool,
              scale: float):
    """(dK, dV) of one attention core, inputs as :func:`flash_dq`.  A CPU
    tensor takes the plain version; any other launches the dK/dV kernel of
    q's dtype (the bf16 form after its split pre-pass, into a scratch the
    wrapper allocates and frees) or raises."""
    _one_dtype("flash_dkv", q=q, k=k, v=v, dout=dout)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, key_mask, dout, lse, delta,
                                   causal, scale)
    inputs = _flash_args(q, k=k, v=v, key_mask=key_mask, dout=dout, lse=lse,
                         delta=delta)
    outputs = (torch.empty_like(inputs[0]), torch.empty_like(inputs[0]))
    if q.dtype == torch.bfloat16:
        B, H, T, D = q.shape
        outputs += (torch.empty(flash_dkv_scratch_bytes(B * H, T, D),
                                dtype=torch.uint8, device=q.device),)
    return _launch_flash(flash_dkv, "dkv", inputs, outputs, causal,
                         scale)[:2]


flash_dkv.launches = 0
flash_dkv.bf16 = LaunchCount()


def flash_delta(dout, out):
    """delta = sum(dO * O, -1) in f32 from dO and O in their own dtype, as
    ``_flash_bwd`` (:333-334) computes it: a bf16 product summed in bf16
    would round every term and the sum, and ds = p (dP - delta) cancels."""
    return (dout.float() * out.float()).sum(dim=-1)


class _FlashAttention(torch.autograd.Function):
    """Forward: :func:`flash_forward`, saving (q, k, v, mask, out, lse).
    Backward: delta = sum(dO * out, -1) in f32 as a torch expression
    (:func:`flash_delta`; XLA computes it outside the kernels too, :333),
    then :func:`flash_dq` and
    :func:`flash_dkv`.  O(T) memory both ways: nothing [T, T] is saved."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale):
        out, lse = flash_forward(q, k, v, key_mask, causal, scale)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.conf = (causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = flash_delta(g, out)
        dq = flash_dq(q, k, v, key_mask, g, lse, delta, *ctx.conf)
        dk, dv = flash_dkv(q, k, v, key_mask, g, lse, delta, *ctx.conf)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, key_mask=None, causal: bool = False,
                    scale: Optional[float] = None):
    """Exact attention with O(T) memory both ways, q, k, v [B, H, T, D],
    key_mask [B, T] (1 keeps the key; None keeps all), ``scale`` 1/sqrt(D)
    unless given, for shapes :func:`flash_attention_supported` takes.
    Differentiable in q, k and v.  CPU tensors run the plain versions
    through the same autograd Function; any other tensor launches the
    kernels or raises.  A query row with no live key gives 0."""
    if not flash_attention_supported(q.shape, q.dtype, k.shape[2]):
        raise ValueError(f"flash attention does not take q{tuple(q.shape)} "
                         f"{q.dtype} with {k.shape[2]} keys")
    B, _, T, D = q.shape
    if key_mask is None:
        key_mask = torch.ones((B, T), dtype=torch.float32, device=q.device)
    scale = float(scale) if scale is not None else 1.0 / D ** 0.5
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashAttention.apply(q, k, v,
                                 key_mask.to(torch.float32).contiguous(),
                                 bool(causal), scale)
