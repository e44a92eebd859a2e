"""The Swin GEMM core's path rule and its launch counts per path.

Every product of K3, K4, K5 (and K6, their training branches), P1 and P2
runs on the card through ``csrc/swin_gemm.cuh``: a LayerNorm pass (bf16
QKV and fc1) or a quantize pass (int8) writes the A operand, then a
persistent wgmma GEMM fed by TMA multiplies it. Which path a product takes
follows from its operand kind and shape alone, by ``gemm_path``, the rule
the C code applies too (``gemm_path_bf16``/``gemm_path_q8``/
``gemm_path_int8w`` there):

- ``"fma"``: float32 products, on the FMA loop of ``swin_common.cuh``
  (TF32 would change float32's numbers);
- ``"wgmma"``: bf16 products and P1's weight-only int8 (``"int8w"``: bf16
  activations times int8 codes) with K % 8 == 0 (TMA's 16-byte row pitch),
  int8 products with K % 16 == 0, N % 64 == 0 for all three (the N tiles,
  ``tile_n``); every product of the Swin-L models takes it. wgmma cannot
  widen int8 operands, so for int8w seven warps of the kernel widen each
  stage's codes into a bf16 B stage themselves (``Int8wOp``;
  ``widened_offset`` is where each code lands);
- ``"loop"``: the rest (``swin_common.cuh``'s WMMA / ``mma.sync`` loops,
  which need K % 32 == 0 and N % 64 == 0 and so refuse those shapes too).

Each library (``LIBRARIES``) counts its products per path twice: here in
``launches``, which each wrapper adds to by the rule when its C entry point
returns, and in the C library itself (``library_launches``), which counts
what it launched. On the card the two must agree. The ``*_loop_cuda``
wrappers run every product on the loop (float32 on the FMA loop): the
parent that ``chip_smoke.py`` compares and times against; no model calls
them.

The plain versions of the split phases: the LayerNorm pass is
``ops.mlp_block.layer_norm_f32``; ``gemm_reference`` is one bf16 / float32
product with its epilogue; ``scale_blocks`` is the C ``ScaleMap`` (which
activation-scale block each token row belongs to),
``quantize_codes_reference`` the quantize pass and ``q8_gemm_reference``
the int8 product over its codes. Composed, they are the plain versions of
K3, K4 and K5 (``tests/test_torch_swin_gemm_plan.py`` holds that).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

PATHS = ("wgmma", "loop", "fma")
LIBRARIES = ("window_mhsa", "mlp_block", "swin_block", "int8_kernel_probe",
             "swin_pack_probe")
KINDS = ("float32", "bfloat16", "int8", "int8w")

# library -> path -> products launched through its wrappers
launches = {lib: dict.fromkeys(PATHS, 0) for lib in LIBRARIES}


def gemm_path(kind: str, k: int, n: int) -> str:
    """The path of one (M, K) x (K, N) product of operand ``kind``
    ("float32", "bfloat16", "int8", or "int8w": bf16 activations times
    int8 weight codes)."""
    if kind == "float32":
        return "fma"
    if kind in ("bfloat16", "int8w"):
        ok = k % 8 == 0 and n % 64 == 0
    elif kind == "int8":
        ok = k % 16 == 0 and n % 64 == 0
    else:
        raise ValueError(f"unknown operand kind {kind!r}; one of {KINDS}")
    return "wgmma" if ok else "loop"


def tile_n(n: int) -> int:
    """The wgmma path's N tile: 128 where it divides N, else 192, else 64
    (N % 64 == 0)."""
    return 128 if n % 128 == 0 else 192 if n % 192 == 0 else 64


# int8w's B stage (csrc/swin_gemm.cuh, wg:: and Int8wOp): a stage is 64 K
# rows; bf16 boxes of 64 N x 64 K rows of 128 bytes, raw boxes of 64 N x 64
# K bytes; the threads that widen them (seven warps)
STAGE_K, ROW_BYTES, WIDEN_THREADS = 64, 128, 224
B_BOX, RAW_BOX = STAGE_K * ROW_BYTES, STAGE_K * 64


def raw_offset(k, n):
    """Where TMA puts code (k, n) of a stage (k < 64, n < BN) in a raw slot:
    unswizzled boxes of 64 N x 64 K bytes, one per 64 columns."""
    return (n // 64) * RAW_BOX + k * 64 + n % 64


def widened_offset(raw):
    """Where the widening warps write the bf16 of the code at byte ``raw``
    of a raw slot: the thread that takes the raw slot's 16-byte chunk c =
    raw // 16 (box c // 256, row k = (c // 4) % 64, codes 16 (c % 4) ..
    + 15) stores its first eight bf16 as chunk 2 (c % 4) and the next eight
    as chunk 2 (c % 4) + 1 of that box's row k, each chunk j at j ^ (k % 8).
    Returns the byte offset of the bf16 (its low byte) in the B stage; works
    elementwise on tensors."""
    c, e = raw // 16, raw % 16
    box, k, q = c // 256, (c // 4) % 64, c % 4
    chunk = (2 * q + e // 8) ^ (k % 8)
    return box * B_BOX + k * ROW_BYTES + chunk * 16 + 2 * (e % 8)


def widen_chunks(bn: int, thread: int) -> range:
    """The raw slot's 16-byte chunks that widening ``thread`` (0-223)
    widens at the N tile ``bn``."""
    return range(thread, bn // 64 * RAW_BOX // 16, WIDEN_THREADS)


def operand_kind(dtype: torch.dtype, quant: bool = False) -> str:
    """The kind of a product over x of ``dtype`` (``quant``: the int8
    branch)."""
    if quant:
        return "int8"
    if dtype == torch.float32:
        return "float32"
    if dtype == torch.bfloat16:
        return "bfloat16"
    raise TypeError(f"the Swin GEMMs take float32 or bfloat16, got {dtype}")


def count(library: str, kind: str, products, loop: bool = False) -> None:
    """Add one launch's products ((K, N) each) to ``library``'s counts, each
    on its path; with ``loop`` (a ``_loop`` entry point) on the loop."""
    for k, n in products:
        path = gemm_path(kind, k, n)
        launches[library]["loop" if loop and path == "wgmma" else path] += 1


def library_launches(library: str) -> dict:
    """The C library's own counts per path since it was loaded or reset
    (``swin_gemm_launches``; builds and loads it: the card only)."""
    from ._build import load_library

    fn = load_library(library).swin_gemm_launches
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    out = (ctypes.c_longlong * len(PATHS))()
    fn(ctypes.addressof(out))
    return dict(zip(PATHS, out))


def reset_launches() -> None:
    """Every library's counts to 0, here and in the C libraries already
    loaded in this process."""
    from ._build import loaded

    for library, counts in launches.items():
        counts.update(dict.fromkeys(PATHS, 0))
        lib = loaded(library)
        if lib is not None:
            reset = lib.swin_gemm_reset
            reset.argtypes, reset.restype = [], None
            reset()


EPILOGUES = ("bias", "bias_gelu", "round_res", "res_f32", "scale")


def gemm_reference(a, w, bias=None, epilogue: str = "bias", res=None,
                   scale=None):
    """One product out = epilogue(a w) in a's dtype, the float32 sum
    rounded once: "bias" T(acc + b); "bias_gelu" T(gelu_erf(acc + b));
    "round_res" T(res + T(acc + b)) (K3's proj, K5's fc2); "res_f32"
    T(acc + b + res) (K4's fc2); "scale" T(acc * scale) (P1's int8w)."""
    acc = torch.matmul(a.float(), w.float())
    if epilogue == "scale":
        return (acc * scale.float()).to(a.dtype)
    u = acc + bias.float()
    if epilogue == "bias":
        out = u
    elif epilogue == "bias_gelu":
        out = F.gelu(u)
    elif epilogue == "round_res":
        out = res.float() + u.to(a.dtype).float()
    elif epilogue == "res_f32":
        out = u + res.float()
    else:
        raise ValueError(f"unknown epilogue {epilogue!r}; one of {EPILOGUES}")
    return out.to(a.dtype)


def scale_blocks(m: int, blk: int = 0, hp: int = 0, wp: int = 0,
                 window: int = 0) -> torch.Tensor:
    """The activation-scale block of each of ``m`` token rows (int64): rows
    in contiguous blocks of ``blk`` (``window`` 0), or the windows of a
    (B, hp, wp) map, numbered row-major per image as the attention phase
    numbers them."""
    r = torch.arange(m)
    if not window:
        return r // blk
    per, t = hp * wp, r % (hp * wp)
    return (((r // per) * (hp // window) + (t // wp) // window)
            * (wp // window) + (t % wp) // window)


def quantize_codes_reference(a, amax):
    """The quantize pass: the int8 codes of a (M, K) float32 with each
    row's block absmax ``amax`` (M, 1) float32 (max |block|, before the
    1e-6): clamp(round(a * (127 / (amax + 1e-6))), -127, 127), the division
    and product rounded in float32, round half to even."""
    inv = 127.0 / (amax + 1e-6)
    return torch.clamp(torch.round(a * inv), -127, 127).to(torch.int8)


def q8_gemm_reference(codes, amax, w):
    """The int8 product over the codes: the exact int32 sums (float64
    products of the codes), then acc * ((amax + 1e-6) / 127 * scale) in
    float32, as ``ops.mlp_block.q8_dot`` dequantizes; w a ``Q8Weight``,
    amax (M, 1) as for ``quantize_codes_reference``. Returns (M, N)
    float32."""
    acc = torch.matmul(codes.double(), w.codes.t().double()).float()
    return acc * (((amax + 1e-6) / 127.0) * w.scale)
