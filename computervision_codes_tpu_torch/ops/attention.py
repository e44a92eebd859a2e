"""Full multi-head attention (K7) and flash attention (K8): hand-written
CUDA kernels + plain versions.

Counterpart of ``computervision_codes_tpu/ops/attention.py``'s
``attention_reference``, ``attention_pallas`` (the TPU kernel) and
``multi_head_attention``. Over (B, H, T, D) query, key and value:

    out = softmax((q * D**-0.5) k^T) v

The kernel (``csrc/attention.cu`` over ``csrc/attention_common.cuh``)
computes what the TPU kernel computes: q scaled in float32, the scores, the
softmax and the PV sum in float32, one rounding to q's dtype at the output;
Tq may differ from Tk. It streams K and V through shared memory in tiles
with an online softmax, so no T x T buffer exists; one launch covers every
(batch, head). In bf16 a producer warpgroup feeds K and V through an
mbarrier ring and one or two consumer warpgroups run both products on
wgmma, the softmax weights rounded to bf16 before the PV product (as
FlashAttention does); in float32 the products run as FMA.
``attention_plan`` chooses the query rows a block takes and, where the
blocks would leave SMs idle, splits the keys over blocks whose partial
results a merge kernel combines through the logsumexp;
``attention_tiles_reference`` is that algorithm in plain PyTorch.
``attention_prev_cuda`` launches the previous design (``mma.sync`` in
bf16, ``csrc/attention_prev.cuh``), the parent ``chip_smoke.py`` times
against; no model calls it. Launches are counted per design, here
(``design_launches``) and in each C library (``library_design_launches``).

The kernel reads q, k and v through their strides (the head dim must be
contiguous), so MS-TCT passes its (B, T, H, D) projections as (B, H, T, D)
views without copies, and the kernel writes its (B, H, Tq, D) output into
(B, Tq, H, D) memory, so that the merge of the heads back to
(B, Tq, H * D) is a view.

``multi_head_attention`` dispatches on the device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel, anything else raises.
Its backward differentiates the plain version, as the JAX ``_mha_bwd``
does (``ops/attention.py:475-480`` there).

K8 is the JAX package's streaming training op: ``flash_attention_pallas``
(the forward) and ``flash_attention`` (differentiable; the forward keeps
the float32 row logsumexp, and the backward runs one kernel over query
tiles for dQ and one over key tiles for dK and dV,
``ops/attention.py:102-454`` there). No model calls it, in either package.
The kernels (``csrc/flash_attention.cu``) compute what the TPU kernels
compute, with P and dS rounded to bf16 before their products in bf16 (the
TPU kernels keep them float32). The plain versions,
``flash_attention_reference_fwd`` and ``flash_attention_reference_bwd``,
compute the same formulas over whole matrices in float32; the CPU takes
them; ``flash_attention_tiles_bwd_reference`` computes them as the bf16
kernels do (P and dS rounded to bf16 before their products). The
``*_prev_cuda`` entry points launch the previous design
(``csrc/flash_prev.cuh``), for timings only. ``block_q`` and ``block_k``
are the TPU kernels' tile sizes: both entry points accept them and ignore
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .mlp_block import on_card, run_entry

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_D_MAX = 128  # head dims up to 128 (MS-TCT's largest is 108)

SMS = 132  # the H100's SMs
# keys per streamed tile (bf16 wgmma, float32 FMA); a split holds at least
# MIN_SPLIT_TILES of them
KEY_TILE = {torch.bfloat16: 64, torch.float32: 32}
MIN_SPLIT_TILES = 2
F32_ROWS = 64  # query rows of a float32 block


@functools.lru_cache(maxsize=256)
def attention_plan(b: int, h: int, tq: int, tk: int, d: int, dtype,
                   sms: int = SMS) -> dict:
    """The forward's launch geometry, as ``csrc/attention_common.cuh``
    takes it: ``rows`` (query rows a block owns: 128, two consumer
    warpgroups, or 64 in bf16; 64 in float32), ``splits`` and ``chunk``
    (the keys are cut into ``splits`` runs of ``chunk`` keys, a multiple of
    the key tile, each a block of its own; the merge kernel combines them)
    and ``grid`` ((B H, query blocks, splits)). The kernels' threads, ring
    and shared memory follow from ``rows`` and D in C, which checks at
    compile time that each fits a block.

    bf16 takes 128 rows at D > 64 where that gives ``sms`` blocks or more,
    else 64 (at D <= 64, 64-row blocks, two an SM, read 5-7% faster on
    an H100 at (1, 8, 8192, D): ``chip_smoke.py``'s 64-against-128
    reading).
    Where the blocks still number fewer than ``sms`` (one video of up to
    about 1,000 frames at 8 heads), the keys are split until every SM has
    a block, each split holding at least MIN_SPLIT_TILES key tiles: so at
    every length MS-TCT runs (1,000-6,000 frames, the training window
    (32, 8, 256), the ragged (2, 8, 1000, 777)) each SM gets a block. Only a
    problem with fewer than ``sms`` x MIN_SPLIT_TILES key tiles over all its
    query blocks leaves SMs idle: there is no more work to spread. Cached:
    treat the dict as read-only."""
    if dtype not in KEY_TILE:
        raise TypeError(f"attention takes float32 or bfloat16, got {dtype}")
    if not (1 <= d <= _D_MAX and tq >= 1 and tk >= 1 and b >= 1 and h >= 1):
        raise ValueError(f"attention needs 1 <= D <= {_D_MAX}, T >= 1, got "
                         f"{(b, h, tq, tk, d)}")
    tile, k16 = KEY_TILE[dtype], -(-d // 16)
    if dtype == torch.bfloat16:  # D <= 64: two 64-row blocks an SM beat one
        rows = (128 if k16 > 4 and b * h * -(-tq // 128) >= sms else 64)
    else:
        rows = F32_ROWS
    qblocks = b * h * -(-tq // rows)
    ktiles = -(-tk // tile)
    splits = 1
    if qblocks < sms:
        splits = max(1, min(-(-sms // qblocks), ktiles // MIN_SPLIT_TILES))
    chunk_tiles = -(-ktiles // splits)
    splits = -(-ktiles // chunk_tiles)
    return {"rows": rows, "splits": splits, "chunk": chunk_tiles * tile,
            "grid": (b * h, -(-tq // rows), splits)}


# the designs: "new", the current kernels (csrc/attention_common.cuh,
# flash_attention.cu), and "prev", the previous ones (attention_prev.cuh,
# flash_prev.cuh), which only the ``*_prev_cuda`` entry points launch;
# each library counts its forward, split-merge, dQ and dK/dV launches per
# design (out[4 d + k] in C)
DESIGNS = ("new", "prev")
COUNTED = ("fwd", "merge", "dq", "dkv")
LIBRARIES = ("attention", "flash_attention")
design_launches = {lib: {f"{k} {d}": 0 for d in DESIGNS for k in COUNTED}
                   for lib in LIBRARIES}


def count_launch(library: str, kernel: str, design: str) -> None:
    """One launch of ``kernel`` of ``library`` in ``design``."""
    design_launches[library][f"{kernel} {design}"] += 1


def library_design_launches(library: str) -> dict:
    """The C library's own launches per kernel and design since it was
    loaded or reset (``attention_launches``; builds and loads it: the card
    only)."""
    from ._build import load_library

    fn = load_library(library).attention_launches
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    out = (ctypes.c_longlong * 8)()
    fn(ctypes.addressof(out))
    return {f"{COUNTED[i % 4]} {DESIGNS[i // 4]}": n
            for i, n in enumerate(out)}


def reset_design_launches() -> None:
    """Both libraries' counts per design to 0, here and in the C libraries
    already loaded in this process."""
    from ._build import loaded

    for library, counts in design_launches.items():
        counts.update(dict.fromkeys(counts, 0))
        lib = loaded(library)
        if lib is not None:
            reset = lib.attention_reset
            reset.argtypes, reset.restype = [], None
            reset()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _forward_plan(q, tk: int):
    """The plan for q's shape on q's card and the float32 split scratch
    (part_o, part_lse), None without a split."""
    b, h, tq, d = q.shape
    plan = attention_plan(b, h, tq, tk, d, q.dtype,
                          _sm_count(q.device.index or 0))
    if plan["splits"] == 1:
        return plan, None, None
    n = plan["splits"] * b * h * tq
    scratch = torch.empty(n * (d + 1), dtype=torch.float32, device=q.device)
    return plan, scratch[:n * d], scratch[n * d:]


def attention_reference(q, k, v):
    """Plain PyTorch version; mirrors the JAX ``attention_reference`` op for
    op in the input dtype: ``q * scale`` and the score product in q's dtype,
    the softmax in float32, the weights cast to v's dtype, the PV product."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def attention_tiles_reference(q, k, v, chunk: int | None = None):
    """The current forward's algorithm (``csrc/attention_common.cuh``) in
    plain PyTorch: the keys in runs of ``chunk`` (one split each; default
    all), each run in tiles of ``KEY_TILE[dtype]`` keys; per tile S = q k^T
    summed in float32, the running row max m in log2 units, P = exp2(s *
    D**-0.5 * log2 e - m) (in bf16 rounded to bf16, the row sum adding the
    rounded weights), O = O alpha + P v; a run's O / l and logsumexp; the
    runs merged through the logsumexp; one rounding to q's dtype. float32
    scales q first, as the kernel does. Returns (out, lse float32)."""
    bf16 = q.dtype == torch.bfloat16
    tile = KEY_TILE[q.dtype]
    scale = q.shape[-1] ** -0.5
    log2e = 1.4426950408889634
    qf, kf, vf = (t.float() for t in (q, k, v))
    if not bf16:
        qf = qf * scale
    sl2 = scale * log2e if bf16 else log2e
    tk = k.shape[2]
    chunk = tk if chunk is None else chunk
    outs, lses = [], []
    for k0 in range(0, tk, chunk):
        m = torch.full(q.shape[:3], -torch.inf)
        l = torch.zeros(q.shape[:3])
        o = torch.zeros(q.shape[:3] + (v.shape[-1],))
        for t0 in range(k0, min(k0 + chunk, tk), tile):
            t1 = min(t0 + tile, k0 + chunk, tk)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, t0:t1])
            mn = torch.maximum(m, s.amax(-1) * sl2)
            alpha = torch.exp2(m - mn)
            p = torch.exp2(torch.addcmul(-mn[..., None], s,
                                         torch.tensor(sl2)))
            if bf16:
                p = p.to(torch.bfloat16).float()
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vf[:, :, t0:t1])
            m = mn
        outs.append(o / l[..., None])
        lses.append((m + torch.log2(l)) / log2e)
    if len(outs) == 1:
        return outs[0].to(q.dtype), lses[0]
    lse = torch.logsumexp(torch.stack(lses), 0)
    out = sum(torch.exp(ls - lse)[..., None] * o for ls, o in zip(lses, outs))
    return out.to(q.dtype), lse


def flash_attention_tiles_bwd_reference(q, k, v, out, lse, g):
    """dq, dk and dv as K8's backward kernels compute them: P = exp2(s *
    D**-0.5 * log2 e - lse log2 e) and dP = dO V^T in float32, dvec =
    rowsum(dO * O) in float32, dS = P (dP - dvec) D**-0.5; in bf16 P and dS
    rounded to bf16 before dV = P^T dO, dQ = dS K and dK = dS^T Q (their
    float32 values feed dS), sums in float32; float32 scales q (dQ) or k
    (dK/dV) first, as the kernels do. Returns (dq, dk, dv) in q's dtype."""
    bf16 = q.dtype == torch.bfloat16
    scale = q.shape[-1] ** -0.5
    log2e = 1.4426950408889634
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    dvec = (gf * out.float()).sum(-1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if bf16:
        p = torch.exp2(s * (scale * log2e) - lse[..., None] * log2e)
    else:
        p = torch.exp2(torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)
                       * log2e - lse[..., None] * log2e)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - dvec[..., None]) \
        * scale
    if bf16:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@functools.cache
def _launch_fn(prev: bool = False):
    """The C entry point of ``csrc/attention.cu`` (built on first use),
    with its argument types declared; ``prev``: the previous design's."""
    from ._build import load_library

    lib = load_library("attention")
    if prev:
        fn = lib.attention_prev_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    else:
        fn = lib.attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def vector_bytes(tensors, es: int) -> int:
    """The widest load (16, 8, 4 or 2 bytes) that every row of every tensor
    allows: base addresses and row strides aligned, the row a whole number
    of vectors."""
    for vb in (16, 8, 4):
        n = vb // es
        if n == 0:
            continue
        if all(t.data_ptr() % vb == 0 and t.shape[-1] % n == 0
               and all(s % n == 0 for s in t.stride()[:-1])
               for t in tensors):
            return vb
    return es


def _check_qkv(name, q, k, v, *more):
    """q (B, H, Tq, D), k and v (B, H, Tk, D), ``more`` shaped as q, one
    dtype (float32 or bf16) on one CUDA device; D <= 128. Returns the
    tensors with the head dim contiguous."""
    on_card(name, q)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, H, T, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    shapes = [(b, h, tk, d)] * 2 + [(b, h, tq, d)] * len(more)
    for arg, t, want in zip(("k", "v", "g"), (k, v) + more, shapes):
        if tuple(t.shape) != want or t.dtype != q.dtype or \
                t.device != q.device:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, want {want} {q.dtype} on "
                             f"{q.device}")
    if not 1 <= d <= _D_MAX or tq < 1 or tk < 1:
        raise ValueError(f"{name} needs 1 <= D <= {_D_MAX} and T >= 1, got "
                         f"D={d}, Tq={tq}, Tk={tk}")
    return [t if t.stride(-1) == 1 else t.contiguous()
            for t in (q, k, v) + more]


def _attention(q, k, v, prev: bool):
    name = "attention_prev_cuda" if prev else "attention_cuda"
    q, k, v = _check_qkv(name, q, k, v)
    b, h, tq, d = q.shape
    out = torch.empty(b, tq, h, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    args = [q, k, v, out, b, h, tq, k.shape[2], d,
            *[s for t in (q, k, v, out) for s in t.stride()[:3]],
            vector_bytes((q, k, v), q.element_size()), _DTYPE_CODES[q.dtype]]
    if not prev:
        plan, part_o, part_lse = _forward_plan(q, k.shape[2])
        args += [plan["rows"], plan["chunk"], plan["splits"], part_o,
                 part_lse]
    err = run_entry(_launch_fn(prev), q.device, *args)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed ({name}): CUDA "
                           f"error {err}")
    design = "prev" if prev else "new"
    count_launch("attention", "fwd", design)
    if not prev and plan["splits"] > 1:
        count_launch("attention", "merge", design)
    return out


def attention_cuda(q, k, v):
    """Launch the CUDA kernel on q's device and current stream.

    q (B, H, Tq, D), k and v (B, H, Tk, D), float32 or bfloat16, one dtype
    on one CUDA device, any strides with the last dim contiguous; D <= 128.
    Returns (B, H, Tq, D) whose memory is (B, Tq, H, D), so
    ``out.transpose(1, 2)`` is contiguous. ``launches`` counts the calls
    that launched the kernel (and, where ``attention_plan`` splits the keys,
    its merge).
    """
    out = _attention(q, k, v, prev=False)
    attention_cuda.launches += 1
    return out


def attention_prev_cuda(q, k, v):
    """``attention_cuda`` in the previous design (one block of 4 warps per
    64 query rows, ``mma.sync`` in bf16, no split): the parent
    ``chip_smoke.py`` times against; no model calls it."""
    out = _attention(q, k, v, prev=True)
    attention_prev_cuda.launches += 1
    return out


attention_cuda.launches = 0
attention_prev_cuda.launches = 0


def _forward(q, k, v):
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type == "cuda":
        return attention_cuda(q, k, v)
    raise ValueError(f"multi_head_attention runs on CPU (plain version) or "
                     f"CUDA (kernel) tensors, got {q.device}")


class _MultiHeadAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, g):
        inputs = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_reference(*inputs)
        return torch.autograd.grad(out, inputs, g)


def multi_head_attention(q, k, v, backend: str = "auto"):
    """Differentiable attention over (B, H, T, D), as the JAX op's
    ``backend``: ``"xla"`` is the plain version on any device (autograd
    through it); ``"pallas"`` and ``"auto"`` the kernel path, the kernel
    forward on CUDA, the plain forward on CPU, the backward through the
    plain version."""
    if backend == "xla":
        return attention_reference(q, k, v)
    if backend not in ("pallas", "auto"):
        raise ValueError(f"unknown attention backend {backend!r}")
    return _MultiHeadAttention.apply(q, k, v)


# ---------------------------------------------------------------------------
# K8: flash attention


def flash_attention_reference_fwd(q, k, v):
    """Plain version of the TPU forward (``_flash_fwd_kernel``): q, k and v
    in float32, s = (q * D**-0.5) k^T, the softmax and the PV sum in
    float32. Returns (out in q's dtype, lse float32 (B, H, Tq))."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]),
                       v.float())
    return out.to(q.dtype), lse


def flash_attention_reference_bwd(q, k, v, out, lse, g):
    """Plain version of the TPU backward (``_flash_bwd``'s dvec and the
    formulas of ``_flash_dq_kernel`` and ``_flash_dkv_kernel``) over whole
    matrices in float32: dvec = rowsum(dO * O), P = exp(s - lse), dS = P *
    (dO V^T - dvec) * scale, dQ = dS K, dV = P^T dO, dK = dS^T Q. Returns
    (dq, dk, dv) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    dvec = (gf * out.float()).sum(-1)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)
                  - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - dvec[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@functools.cache
def _flash_fns():
    """The C entry points of ``csrc/flash_attention.cu`` (built on first
    use), with their argument types declared: the forward, the previous
    design's forward, and the backward (either design)."""
    from ._build import load_library

    lib = load_library("flash_attention")
    fwd = lib.flash_attention_fwd_launch
    fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p] * 3)
    fwd_prev = lib.flash_attention_fwd_prev_launch
    fwd_prev.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_longlong] * 12
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    bwd = lib.flash_attention_bwd_launch
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                    + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 21
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fwd.restype = fwd_prev.restype = bwd.restype = ctypes.c_int
    return fwd, fwd_prev, bwd


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _flash_fwd(q, k, v, with_lse: bool, prev: bool):
    name = ("flash_attention_fwd_prev_cuda" if prev
            else "flash_attention_fwd_cuda")
    q, k, v = _check_qkv(name, q, k, v)
    b, h, tq, d = q.shape
    out = torch.empty(b, h, tq, d, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    fwd, fwd_prev, _ = _flash_fns()
    args = [q, k, v, out, lse, b, h, tq, k.shape[2], d,
            *_strides(q, k, v, out), vector_bytes((q, k, v), q.element_size()),
            _DTYPE_CODES[q.dtype]]
    if not prev:
        plan, part_o, part_lse = _forward_plan(q, k.shape[2])
        args += [plan["rows"], plan["chunk"], plan["splits"], part_o,
                 part_lse]
    err = run_entry(fwd_prev if prev else fwd, q.device, *args)
    if err != 0:
        raise RuntimeError(f"flash attention forward launch failed ({name}): "
                           f"CUDA error {err}")
    design = "prev" if prev else "new"
    count_launch("flash_attention", "fwd", design)
    if not prev and plan["splits"] > 1:
        count_launch("flash_attention", "merge", design)
    return out, lse


def flash_attention_fwd_cuda(q, k, v, with_lse: bool = True):
    """Launch K8's forward on q's device and current stream. q (B, H, Tq,
    D), k and v (B, H, Tk, D), float32 or bfloat16, any strides with the
    head dim contiguous. Returns (out (B, H, Tq, D) contiguous, lse float32
    (B, H, Tq) or None). ``launches`` counts the calls (a split's merge
    included)."""
    out = _flash_fwd(q, k, v, with_lse, prev=False)
    flash_attention_fwd_cuda.launches += 1
    return out


def flash_attention_fwd_prev_cuda(q, k, v, with_lse: bool = True):
    """K8's forward in the previous design, for timings only."""
    out = _flash_fwd(q, k, v, with_lse, prev=True)
    flash_attention_fwd_prev_cuda.launches += 1
    return out


def _flash_bwd_launch(kind: int, prev: bool, q, k, v, g, lse, dvec, dq, dk,
                      dv):
    b, h, tq, d = q.shape
    if tuple(lse.shape) != (b, h, tq) or tuple(dvec.shape) != (b, h, tq) or \
            lse.dtype != torch.float32 or dvec.dtype != torch.float32 or \
            not (lse.is_contiguous() and dvec.is_contiguous()):
        raise ValueError(f"lse and dvec must be contiguous float32 "
                         f"{(b, h, tq)}")
    _, _, bwd = _flash_fns()
    err = run_entry(
        bwd, q.device, kind, q, k, v, g, lse, dvec, dq, dk, dv, b, h, tq,
        k.shape[2], d, *_strides(q, k, v, g),
        *(s for t in (dq, dk, dv)
          for s in (t.stride()[:3] if t is not None else (0,) * 3)),
        vector_bytes((q, k, v, g), q.element_size()), _DTYPE_CODES[q.dtype],
        int(prev))
    which = "dQ" if kind == 0 else "dK/dV"
    if err != 0:
        raise RuntimeError(f"flash attention backward launch ({which}"
                           f"{', previous design' if prev else ''}) failed: "
                           f"CUDA error {err}")
    count_launch("flash_attention", "dq" if kind == 0 else "dkv",
                 "prev" if prev else "new")


def _flash_dq(q, k, v, g, lse, dvec, prev: bool):
    q, k, v, g = _check_qkv("flash_attention_dq_cuda", q, k, v, g)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash_bwd_launch(0, prev, q, k, v, g, lse, dvec, dq, None, None)
    return dq


def _flash_dkv(q, k, v, g, lse, dvec, prev: bool):
    q, k, v, g = _check_qkv("flash_attention_dkv_cuda", q, k, v, g)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    _flash_bwd_launch(1, prev, q, k, v, g, lse, dvec, None, dk, dv)
    return dk, dv


def flash_attention_dq_cuda(q, k, v, g, lse, dvec):
    """Launch K8's dQ kernel: g (dO) shaped as q, lse and dvec float32
    (B, H, Tq) contiguous. Returns dq (B, H, Tq, D) in q's dtype."""
    dq = _flash_dq(q, k, v, g, lse, dvec, prev=False)
    flash_attention_dq_cuda.launches += 1
    return dq


def flash_attention_dkv_cuda(q, k, v, g, lse, dvec):
    """Launch K8's dK/dV kernel (arguments as ``flash_attention_dq_cuda``).
    Returns (dk, dv), each (B, H, Tk, D) in q's dtype."""
    out = _flash_dkv(q, k, v, g, lse, dvec, prev=False)
    flash_attention_dkv_cuda.launches += 1
    return out


def flash_attention_dq_prev_cuda(q, k, v, g, lse, dvec):
    """K8's dQ kernel in the previous design, for timings only."""
    dq = _flash_dq(q, k, v, g, lse, dvec, prev=True)
    flash_attention_dq_prev_cuda.launches += 1
    return dq


def flash_attention_dkv_prev_cuda(q, k, v, g, lse, dvec):
    """K8's dK/dV kernel in the previous design, for timings only."""
    out = _flash_dkv(q, k, v, g, lse, dvec, prev=True)
    flash_attention_dkv_prev_cuda.launches += 1
    return out


for _fn in (flash_attention_fwd_cuda, flash_attention_dq_cuda,
            flash_attention_dkv_cuda, flash_attention_fwd_prev_cuda,
            flash_attention_dq_prev_cuda, flash_attention_dkv_prev_cuda):
    _fn.launches = 0


def _flash_device(q) -> str:
    if q.device.type in ("cpu", "cuda"):
        return q.device.type
    raise ValueError(f"flash attention runs on CPU (plain version) or CUDA "
                     f"(kernel) tensors, got {q.device}")


def flash_attention_pallas(q, k, v, block_q: int = 256, block_k: int = 512):
    """Streaming attention over (B, H, T, D), forward only: the plain
    version on the CPU, K8's forward (no lse) on CUDA."""
    if _flash_device(q) == "cpu":
        return flash_attention_reference_fwd(q, k, v)[0]
    return flash_attention_fwd_cuda(q, k, v, with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if _flash_device(q) == "cpu":
            out, lse = flash_attention_reference_fwd(q, k, v)
        else:
            out, lse = flash_attention_fwd_cuda(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return flash_attention_reference_bwd(q, k, v, out, lse, g)
        dvec = (g.float() * out.float()).sum(-1)  # rowsum(dO * O), as JAX
        dq = flash_attention_dq_cuda(q, k, v, g, lse, dvec)
        dk, dv = flash_attention_dkv_cuda(q, k, v, g, lse, dvec)
        return dq, dk, dv


def flash_attention(q, k, v, block_q: int = 256, block_k: int = 512):
    """Differentiable streaming attention over (B, H, T, D): on CUDA K8's
    forward (keeping the lse), then its dQ and dK/dV kernels backward; on
    the CPU the plain versions."""
    return _FlashAttention.apply(q, k, v)
