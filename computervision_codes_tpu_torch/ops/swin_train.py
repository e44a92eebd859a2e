"""K6: the Swin half-blocks of the training forward, kernel forward and
plain backward.

Counterpart of ``computervision_codes_tpu/ops/swin_train.py``. Each branch
is a ``torch.autograd.Function`` whose forward is K3 (``make_attn_branch``)
or K4 (``make_mlp_branch``) at ``res_add=False``, the branch without its
residual, so that the module puts DropPath between the branch and the
residual, and whose backward is autograd of the plain version at the saved
inputs, as the JAX ``custom_vjp`` differentiates its XLA reference. JAX has
no backward kernel here, so the port writes none: the backward's products
run on cuBLAS. Every argument gets a gradient but the shift mask: x, both
LayerNorm vectors, the weights and biases, and the relative-position bias
(through which the bias table's gradient flows).

On a CPU tensor the forward is the plain version; on a CUDA tensor it
launches the kernel (``csrc/window_mhsa.cu`` / ``csrc/mlp_block.cu`` with
``res_add`` 0) through ``window_mhsa_branch_cuda`` / ``mlp_block_branch_cuda``,
whose ``launches`` count K6 apart from the eval launches of K3 and K4; any
other device raises. Under ``torch.utils.checkpoint`` the replayed forward
launches the kernel again, as the JAX replay runs the Pallas kernel.
"""

from __future__ import annotations

import functools

import torch

from .mlp_block import launch_mlp_block, mlp_block_reference
from .window_mhsa import launch_window_mhsa, window_mhsa_reference


def window_mhsa_branch_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                            mask, *, window: int, num_heads: int):
    """Launch K6's attention branch (K3's float path without the residual)
    on x's device and current stream. ``launches`` counts its launches."""
    return launch_window_mhsa(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias,
                              mask, window=window, num_heads=num_heads,
                              res_add=False, counter=window_mhsa_branch_cuda)


window_mhsa_branch_cuda.launches = 0


def mlp_block_branch_cuda(x, gamma, beta, w1, b1, w2, b2):
    """Launch K6's MLP branch (K4's float path without the residual) on x's
    device and current stream. ``launches`` counts its launches."""
    return launch_mlp_block(x, gamma, beta, w1, b1, w2, b2, res_add=False,
                            counter=mlp_block_branch_cuda)


mlp_block_branch_cuda.launches = 0


def _branch(name: str, kernel, reference, n_grad: int):
    """An autograd.Function over ``n_grad`` differentiable arguments
    followed by any without a gradient (the mask): ``kernel`` forward on
    CUDA, ``reference`` forward on CPU, backward through ``reference``."""

    def run(*args):
        device = args[0].device.type
        if device == "cpu":
            return reference(*args)
        if device == "cuda":
            return kernel(*args)
        raise ValueError(f"{name} runs on CPU (plain version) or CUDA "
                         f"(kernel) tensors, got {args[0].device}")

    class Branch(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args[:n_grad])
            ctx.rest = args[n_grad:]
            return run(*args)

        @staticmethod
        def backward(ctx, g):
            inputs = [a.detach().requires_grad_(need) for a, need in
                      zip(ctx.saved_tensors, ctx.needs_input_grad)]
            wanted = [a for a in inputs if a.requires_grad]
            with torch.enable_grad():
                out = reference(*inputs, *ctx.rest)
            grads = iter(torch.autograd.grad(out, wanted, g))
            return (*(next(grads) if a.requires_grad else None
                      for a in inputs), *(None,) * len(ctx.rest))

    Branch.__name__ = Branch.__qualname__ = name
    return Branch


@functools.lru_cache(maxsize=None)
def make_attn_branch(window: int, num_heads: int, use_mask: bool = True):
    """The attention branch f(x, gamma, beta, wqkv, bqkv, wproj, bproj,
    bias[, mask]) -> proj(attn(LN(x))) with no residual, as a
    ``torch.autograd.Function`` (call ``.apply``). ``use_mask=False`` takes
    no mask argument (an unshifted block)."""

    def split(args):
        return args[:8], args[8] if use_mask else None

    def kernel(*args):
        dense, mask = split(args)
        return window_mhsa_branch_cuda(*dense, mask, window=window,
                                       num_heads=num_heads)

    def reference(*args):
        dense, mask = split(args)
        return window_mhsa_reference(*dense, mask, window=window,
                                     num_heads=num_heads, res_add=False)

    return _branch("AttnBranch", kernel, reference, 8)


@functools.lru_cache(maxsize=None)
def make_mlp_branch():
    """The MLP branch f(x, gamma, beta, w1, b1, w2, b2) -> mlp(LN(x)) with
    no residual, as a ``torch.autograd.Function`` (call ``.apply``)."""

    def reference(*args):
        return mlp_block_reference(*args, res_add=False)

    return _branch("MlpBranch", mlp_block_branch_cuda, reference, 7)
